"""optim subpackage."""
