#!/usr/bin/env python3
"""Where the time of the chunked scan bodies goes, on one NVIDIA GPU.

    python3 scan_phases.py

It builds variants of the sources of the chunked RG-LRU body
(``csrc/rglru_scan.cu``) and the chunked WKV body (``csrc/wkv6_chunk.cu``)
that stop after each phase of the kernel, and times each variant at the
prefill shape that serving gives it: recurrentgemma-9b's [1, 2560, 4096] and
rwkv6-3b's [1, 512, 40, 64], bf16 inputs. The difference between two
neighbouring cuts is the time of the phase between them. It also prints how
many CTAs of each kernel fit on an SM (``cudaOccupancyMaxActiveBlocksPer
Multiprocessor``) and the device time of each of the WKV body's three
launches (``torch.profiler``).

Times: CUDA events over 20 calls after warm-up, the inputs the same in each
call (they are read once a call, from device memory: 63 MB and 21 MB, larger
than a pass's worth of L2 reuse). The RG-LRU's look-back flags are zeroed
before the timed calls, so its times are the kernel's alone. Variants are
built with nvcc (one process each, started together, the sources'
headers on the include path) into build/kernels/phases/. It exits 2 without
a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "kernels" / "phases"
STOP = "  if (T_ > 0) return;  // the cut\n"

# (name, source, anchor): the variant stops just before ``anchor``; None
# keeps the whole kernel. Each anchor must occur once in its source.
RGLRU_CUTS = [
    ("staging", "  // pass 1: the quarter's map"),
    ("pass 1", "  // the chunk's map and the carry, by quarter 0"),
    ("carry (publish, look-back)", "  // pass 2: rescan the quarter"),
    ("pass 2 (whole kernel)", None),
]
WKV_CUTS = [
    ("staging", "  __syncthreads();\n\n  // Within the sub-chunk, on the CUDA cores"),
    ("diagonal blocks", "  take_logs(qs, LDA);\n  __syncthreads();\n\n  // the runs"),
    ("runs of log w, decays", "  float* as = ps;\n"),
    ("off-diagonal blocks", "  // y = A V + R̃ S_c over this warp's rows"),
    ("y (whole kernel)", None),
]
OCCUPANCY = {
    "rglru_scan.cu": """
extern "C" int occupancy(int smem) {
  int n = -1;
  auto k = rglru_chunk_kernel<__nv_bfloat16, true>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, NTC, smem);
  return n;
}
""",
    "wkv6_chunk.cu": """
extern "C" int occupancy(int which) {
  int n = -1;
  if (which == 0) {
    auto k = wkv_summary_kernel<__nv_bfloat16>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SUMMARY_SMEM);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, NT, SUMMARY_SMEM);
  } else {
    auto k = wkv_output_kernel<__nv_bfloat16>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, OUTPUT_SMEM);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, NT, OUTPUT_SMEM);
  }
  return n;
}
""",
}


def variants(source, cuts):
    """Write one .cu per cut; return [(cut name, path)]."""
    text = (CSRC / source).read_text()
    out = []
    for i, (name, anchor) in enumerate(cuts):
        if anchor is None:
            body = text + OCCUPANCY[source]
        else:
            if text.count(anchor) != 1:
                raise RuntimeError(f"{source}: the cut before {anchor!r} "
                                   "is not in the source once")
            body = text.replace(anchor, STOP + anchor)
        path = OUT / f"{Path(source).stem}_{i}.cu"
        path.write_text(body)
        out.append((name, path))
    return out


def build(paths):
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kb
    procs = [(p, subprocess.Popen(
        [kb.nvcc(), *kb.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
         "-I", str(CSRC), "-shared", "-o", str(p.with_suffix(".so")), str(p)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for p in paths]
    libs = {}
    for p, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {p.name}:\n{log}")
        libs[p] = ctypes.CDLL(str(p.with_suffix(".so")))
    return libs


def time_calls(call, n=20):
    call(0), call(1)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        call(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_phases: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    rg = variants("rglru_scan.cu", RGLRU_CUTS)
    wk = variants("wkv6_chunk.cu", WKV_CUTS)
    libs = build([p for _, p in rg + wk])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    dev, g = "cuda", torch.Generator(device="cuda")
    g.manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    result = {"card": card}

    # K2 chunked body at recurrentgemma-9b's prefill
    from repro_torch.kernels import rglru, rwkv6
    B, T, W = 1, 2560, 4096
    x, r, i = (torch.randn(B, T, W, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    r, i = torch.sigmoid(r), torch.sigmoid(i)
    a_log, h0 = torch.randn(W, device=dev), torch.randn(B, W, device=dev)
    y, h = torch.empty(B, T, W, device=dev), torch.empty(B, W, device=dev)
    p = rglru.plan(B, T, W, torch.bfloat16)
    n_chunks = -(-T // p.chunk)
    flags = [torch.zeros(p.grid[0] + 1, dtype=torch.int32, device=dev)
             for _ in range(22)]
    pairs = torch.empty(3, B, n_chunks, W, device=dev)
    rows = []
    for name, path in rg:
        fn = libs[path].rglru_scan_chunked
        fn.argtypes = [ptr] * 9 + [i32] * 7 + [ptr]
        fn.restype = i32
        for f in flags:
            f.zero_()

        def call(k, fn=fn):
            rc = fn(x.data_ptr(), r.data_ptr(), i.data_ptr(), a_log.data_ptr(),
                    h0.data_ptr(), y.data_ptr(), h.data_ptr(),
                    flags[k].data_ptr(), pairs.data_ptr(), B, T, W, 1, 0,
                    p.chunk, 1, stream())
            assert rc == 0, rc
        rows.append((name, time_calls(call)))
    smem = 4 * p.chunk * rglru.LANES * 16
    result["rglru_chunked"] = {"shape": [B, T, W], "chunk": p.chunk,
                               "ctas": p.grid[0], "cuts_ms": dict(rows),
                               "ctas_per_sm": libs[rg[-1][1]].occupancy(smem)}

    # K3 chunked body at rwkv6-3b's prefill
    B, T, H, hd = 1, 512, 40, 64
    rr, kk, vv = (torch.randn(B, T, H, hd, generator=g, device=dev)
                  .to(torch.bfloat16) for _ in range(3))
    w = torch.sigmoid(torch.randn(B, T, H, hd, generator=g, device=dev))
    u = torch.randn(H, hd, device=dev).to(torch.bfloat16)
    s0 = torch.randn(B, H, hd, hd, device=dev)
    yw, sw = torch.empty(B, T, H, hd, device=dev), torch.empty_like(s0)
    n = -(-T // rwkv6.CHUNK)
    scratch = torch.empty(B, H, n, 64, 64, device=dev)
    decay = torch.empty(B, H, n, 64, device=dev)
    rows, launches = [], {}
    for name, path in wk:
        fn = libs[path].wkv6_scan_chunked
        fn.argtypes = [ptr] * 10 + [i32] * 7 + [ptr]
        fn.restype = i32

        def call(k, fn=fn):
            rc = fn(rr.data_ptr(), kk.data_ptr(), vv.data_ptr(), w.data_ptr(),
                    u.data_ptr(), s0.data_ptr(), yw.data_ptr(), sw.data_ptr(),
                    scratch.data_ptr(), decay.data_ptr(), B, T, H, hd, 1, 1,
                    1, stream())
            assert rc == 0, rc
        rows.append((name, time_calls(call)))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for k in range(10):
            call(k)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        name = re.search(r"(\w+_kernel)", e.key)
        if e.device_type == torch.autograd.DeviceType.CUDA and name:
            launches[name.group(1)] = e.device_time_total / e.count / 1e3
    lib = libs[wk[-1][1]]
    result["wkv6_chunked"] = {
        "shape": [B, T, H, hd], "cuts_ms": dict(rows),
        "launch_device_ms": launches,
        "ctas_per_sm": {"summary": lib.occupancy(0), "output": lib.occupancy(1)},
        "ctas": {"summary": n * H * B, "output": n * H * B}}

    print(card)
    for kernel in ("rglru_chunked", "wkv6_chunked"):
        res, prev = result[kernel], 0.0
        print(f"{kernel} {res['shape']}: {res['ctas_per_sm']} CTAs/SM")
        for name, ms in res["cuts_ms"].items():
            print(f"  up to {name:28s} {ms:.4f} ms  (+{ms - prev:.4f})")
            prev = ms
    for kernel, ms in result["wkv6_chunked"]["launch_device_ms"].items():
        print(f"  wkv6 launch {kernel:22s} {ms:.4f} ms device")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
