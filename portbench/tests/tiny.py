"""Cells of the manifest cut to a size the CPU tests can run in seconds:
the same files, the widths and the traffic made small, the kernels' plain
versions (the port sends CPU tensors to them)."""
import copy
import time

from portbench import harness, manifest

SEED = 2 ** 31 + 12345          # past 32 signed bits, as the driver's are


def config(conf, dtype="float32", train=False, drops=False):
    """Small widths; a training state stays fp32, serving weights take
    ``dtype``. A MoE configuration keeps the file's window and capacity
    factor; with ``drops`` it takes a window of 32 and a capacity at the
    mean load instead, so that the reference's window and drop rules run
    too."""
    c = copy.deepcopy(conf)
    moe = bool(c.get("num_local_experts"))
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             head_dim=16, intermediate_size=32 if moe else 128,
             vocab_size=512, num_hidden_layers=2,
             dtypes={"weights": "float32" if train else dtype,
                     "compute": dtype})
    if moe:
        c.update(num_local_experts=4)
    if moe and drops:
        # capacity at the mean load: a prompt's assignments are dropped
        c.update(sliding_window=32, capacity_factor=1.0)
    return c


def cell(name, dtype="float32", limits=None):
    """The manifest's cell ``name``, small; ``<cell>+drops`` is the cell
    with :func:`config`'s ``drops``."""
    base, _, variant = name.partition("+")
    c = manifest.load_cell(base, manifest.load_manifest())
    c.config = config(c.config, dtype, train=c.cell["kind"] == "train",
                      drops=variant == "drops")
    if c.cell["kind"] == "serve":
        # one prompt stratum: a pass, and so a zero-second window, is one
        # wave
        c.mix = dict(c.mix, slots=4, ctx=96, wave_size=4,
                     prompt_len={"dist": "uniform", "low": 40, "high": 40,
                                 "strata": 1},
                     output_len={"dist": "loguniform", "low": 4, "high": 12},
                     trace_decode_steps=2)
        # every request of the one wave a zero-second window serves: the
        # check then reads the same tokens however loaded the machine is
        c.cell = dict(c.cell, check={"requests": 4, "limits": limits or {
            "widest_gap": 1e-3}})
    else:
        c.mix = dict(c.mix, global_batch=2, seq_len=32)
        c.cell = dict(c.cell, check={"limits": limits or {
            "loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3,
            "store_mismatches": 0}})
    return c


def run(c, trace=False, seconds=0.0, seed=SEED):
    """One run on the CPU; a zero-second window holds one wave or step."""
    return harness.run(c, seed, seconds, trace, time.perf_counter(),
                       device="cpu")
