"""Roofline share of M1 (``csrc/moe_gemm.cu``, the MoE layer's grouped
experts) in serving's traced stretch, in %: the least time of each of its
calls, the larger of its operations (6 D Fe a routed row) at the bf16 peak
and its bytes (the weights of the held experts with rows, the rows read and
written) at HBM's rate, from the rows and experts the layer counted itself
(``record["expert_rows"]``, ``drivers/serve_share.py``), over the device
time of the ``moe_gemm_kernel`` launches in the stretch."""
from portbench.drivers.serve_share import MOE_GEMM_KERNEL, moe_gemm_least_s


def read(record):
    rows = record.get("expert_rows") or {}
    st = record.get("stretch") or {}
    if record.get("kind") != "serve" or not rows.get("calls"):
        return None
    device = sum(s for name, s in st.get("device_ops", ())
                 if MOE_GEMM_KERNEL in name)
    least = moe_gemm_least_s(rows["calls"], rows["d_model"], rows["d_ff"],
                             rows["elem"])
    if not device or not least:
        return None
    return least / device * 100
