"""The plain reference: the configurations' forward pass, loss and AdamW in
plain PyTorch, fp32 with TF32 off. It imports nothing of the port and
nothing of JAX; it reads the configuration's file and the benchmark's own
weights, and works out everything else again."""
