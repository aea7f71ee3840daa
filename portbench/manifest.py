"""Finds a cell's files by the names in ``BENCHMARK.json``.

* ``portbench/workloads/<cell>.json``: the cell (its configuration, its
  traffic mix, the entry kind, the layers it holds, its limits, why);
* ``portbench/configs/<config>.json``: the configuration as it is run;
* ``portbench/traffic/<mix>.json``: the traffic mix's parameters;
* ``portbench/metrics/<metric>.py``: the reader of one per-layer metric.

Adding a cell, a configuration, a mix or a metric adds files and manifest
entries; no file here needs an edit.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the configuration files' "dtypes" names
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def load_manifest(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(kind: str, name: str) -> Dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


@dataclass
class Cell:
    name: str
    spec: Dict          # the manifest's entry
    cell: Dict          # workloads/<cell>.json
    config: Dict        # configs/<config>.json
    mix: Dict           # traffic/<mix>.json
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def chips(self) -> int:
        return int(self.spec["chips"])


def _reported_in(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: Dict) -> Cell:
    specs = {w["name"]: w for w in manifest["workloads"]}
    if name not in specs:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{sorted(specs)})")
    spec = specs[name]
    cell = _json("workloads", name)
    if cell["config"] != spec["config"] or cell["traffic"] != spec["traffic"]:
        raise ValueError(f"{name}: workloads/{name}.json names "
                         f"{cell['config']} x {cell['traffic']}, the "
                         f"manifest {spec['config']} x {spec['traffic']}")
    return Cell(name, spec, cell, _json("configs", spec["config"]),
                _json("traffic", spec["traffic"]),
                [m for m in manifest["end_to_end"] if _reported_in(m, name)],
                [m for m in manifest["per_layer"] if _reported_in(m, name)])


def metric_reader(name: str) -> Callable:
    """``read(record) -> float | None`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def port_config(conf: Dict):
    """The port's ``ModelConfig`` that ``conf`` describes: the registered
    architecture ``conf["port_arch"]`` with every size taken from the file
    (tests build small ones this way; for the shipped files a test holds
    the result equal to the registered config but for the depth)."""
    import dataclasses

    from repro_torch.models import LayerGroup, get_config

    base = get_config(conf["port_arch"])
    experts = int(conf.get("num_local_experts", 0))
    window = conf.get("sliding_window")
    kind = "local" if window else "attn"
    return dataclasses.replace(
        base,
        d_model=conf["hidden_size"],
        n_heads=conf["num_attention_heads"],
        n_kv_heads=conf["num_key_value_heads"],
        head_dim=conf["head_dim"],
        d_ff=conf["intermediate_size"],
        vocab=conf["vocab_size"],
        groups=(LayerGroup((kind,), conf["num_hidden_layers"]),),
        qk_norm=bool(conf["qk_norm"]),
        attn_window=window,
        rope_theta=float(conf["rope_theta"]),
        norm_eps=float(conf["rms_norm_eps"]),
        tie_embeddings=bool(conf["tie_word_embeddings"]),
        ffn_kind="moe" if experts else "swiglu",
        n_experts=experts,
        top_k=int(conf.get("num_experts_per_tok", 0)),
        moe_d_ff=conf["intermediate_size"] if experts else None,
        capacity_factor=float(conf.get("capacity_factor",
                                       base.capacity_factor)),
    )
