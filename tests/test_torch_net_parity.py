"""The port's copy of the OptSVA-CF wire against the JAX package's, on the
CPU: frames byte for byte, the deterministic simulation's schedule traces
and final states, the transport-equivalence schedule, the SVA / TFA / 2PL
baselines and the Chrome-trace export.

Every comparison is exact. Both packages run the same code (the port's
modules are line-for-line copies), so a seeded simulation must give the
same trace in both; class paths are read as the reference's before
comparing (``torch_port.as_reference``).
"""
import json
import pickle
import pickletools

import pytest

import benchmarks.simsweep as ref_sweep
from repro import core as rcore
from repro.net import wire as rwire
from repro.obs import export as rexport
from repro.obs import txtrace as rtxtrace
from repro_torch import core as pcore
from repro_torch.net import wire as pwire
from repro_torch.obs import export as pexport
from repro_torch.obs import txtrace as ptxtrace
from torch_port import as_reference, port_of

port_sweep = port_of("benchmarks/simsweep.py")


# ---------------------------------------------------------------------------
# The wire: the same messages, the same frame segments
# ---------------------------------------------------------------------------
class _Unpicklable(Exception):
    def __init__(self):
        super().__init__("holds a lambda")
        self.fn = lambda: None


def _messages(w):
    """Messages of every kind ``w`` (a wire module) frames: requests,
    one-ways, replies with notes, errors, pushes, small and out-of-band
    payloads, and a pickle past the single-buffer fast path."""
    state = bytes(range(256)) * 40                      # 10 KiB: out of band
    return {
        "request": (7, "open_call", {
            "txn": "host:1:ab12cd#3r0", "name": "A", "kind": "update",
            "timeout": None, "entries": [("deposit", (5,), {})],
            "method": "balance", "args": (), "kwargs": {},
            "modifies": False, "want_state": True}),
        "oneway": (None, "release", {"txn": "host:1:ab12cd#3r0",
                                     "name": "A"}),
        "reply-notes": (7, w.OK, {"blocked": False, "instance": 2,
                                  "value": 900},
                        [("task_done", "host:1:ab12cd#3r0", "A", None),
                         ("oneway_err", "host:1:ab12cd#4r0", "B",
                          "boom")]),
        "error": (8, w.ERR, w.encode_error(KeyError("A")), []),
        "error-degraded": (9, w.ERR, w.encode_error(_Unpicklable()), []),
        "push": (None, w.NOTE, None, [("task_done", "c#1r0", "C", None)]),
        "small-payload": (10, w.OK, {"state": w.oob(b"x" * 100)}, []),
        "oob-payload": (11, w.OK, {"state": w.oob(state)},
                        [("task_done", "c#2r0", "D", w.oob(state[::-1]))]),
        "large-inband": (12, w.OK, "y" * 70_000, []),
    }


def _plain(msg):
    """``msg`` as a receiver sees it: out-of-band buffers come back as
    bytes, an exception as its type and arguments."""
    if isinstance(msg, pickle.PickleBuffer):
        return bytes(msg.raw())
    if isinstance(msg, BaseException):
        return (type(msg).__name__, msg.args)
    if isinstance(msg, dict):
        return {k: _plain(v) for k, v in msg.items()}
    if isinstance(msg, (list, tuple)):
        return type(msg)(_plain(v) for v in msg)
    return msg


@pytest.mark.parametrize("kind", list(_messages(rwire)))
def test_wire_frames_are_byte_identical(kind):
    ref_msg, port_msg = _messages(rwire)[kind], _messages(pwire)[kind]
    ref_segs = [bytes(s) for s in rwire.encode_segments(ref_msg)]
    port_segs = [bytes(s) for s in pwire.encode_segments(port_msg)]
    assert port_segs == ref_segs
    assert pwire.frame(port_msg) == rwire.frame(ref_msg)
    if kind == "oob-payload":
        assert len(ref_segs) == 4          # header, pickle, two buffers
    body = pwire.frame(port_msg)[4:]
    assert _plain(pwire.decode_payload(body)) == _plain(ref_msg)
    assert _plain(rwire.decode_payload(body)) == _plain(ref_msg)


def test_wire_package_errors_decode_to_each_packages_class():
    """An error of the package's own class frames under its own class path:
    equal after the path is read as the reference's, and each decodes to
    its package's class."""
    for w, api in ((rwire, rcore.api), (pwire, pcore.api)):
        err = api.RemoteObjectFailure("node n0 unreachable")
        got = w.decode_payload(w.frame((3, w.ERR, w.encode_error(err),
                                        []))[4:])
        assert type(got[2]) is api.RemoteObjectFailure
        assert got[2].args == err.args
    def ops(w, api):
        frame = w.frame((3, w.ERR, api.RemoteObjectFailure("x"), []))
        return [(op.name, as_reference(arg) if isinstance(arg, str) else arg)
                for op, arg, _ in pickletools.genops(frame[9:])
                if op.name != "FRAME"]          # the frame's length differs
    assert ops(pwire, pcore.api) == ops(rwire, rcore.api)


def test_address_parsing_and_frame_cap_match():
    assert pwire.parse_address("10.0.0.2:7001") == rwire.parse_address(
        "10.0.0.2:7001")
    assert pwire.parse_address(":9") == rwire.parse_address(":9")
    assert (pwire.MAX_FRAME, pwire.PIGGYBACK_MAX, pwire.OOB_MIN) == (
        rwire.MAX_FRAME, rwire.PIGGYBACK_MAX, rwire.OOB_MIN)


# ---------------------------------------------------------------------------
# The deterministic simulation: simsweep's seeded workload in both packages
# ---------------------------------------------------------------------------
def _rollbacks(net):
    return sum(len(n.monitor.rollbacks) for n in net._nodes.values())


# (seed, run_seed options, what the run must have exercised)
SIM_CASES = {
    "mixed": (0, dict(faults=False), None),
    "client-crash": (8, dict(), "rollback"),
    "node-wal-replay": (9, dict(node_faults=True, restarts=True), "replay"),
    "node-chain-restart": (13, dict(node_faults=True, restarts=True),
                           "replay"),
    "partition-lease": (1, dict(node_faults=True, partitions=True), "fence"),
    "commute": (2, dict(faults=False, commute=True), "merge"),
    "commute-faults": (5, dict(commute=True, node_faults=True,
                               restarts=True), "merge"),
}


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_simnet_seed_gives_the_same_trace_and_state(case):
    seed, kw, needs = SIM_CASES[case]
    ref = ref_sweep.run_seed(seed, keep_net=True, **kw)
    port = port_sweep.run_seed(seed, keep_net=True, **kw)
    ref_net, port_net = ref.pop("net"), port.pop("net")
    try:
        assert ref["failures"] == [] and port["failures"] == []
        assert as_reference(port.pop("trace")) == ref.pop("trace")
        assert port == ref          # balances, commits, aborts, injections
        nodes = port_net._nodes.values()
        if needs == "rollback":
            assert ref["injected"] == "pre-commit"
            assert _rollbacks(port_net) == _rollbacks(ref_net) > 0
        elif needs == "replay":
            assert any(n._recovered is not None and n._recovered.objects
                       for n in nodes)
        elif needs == "fence":
            assert ref["partitioned"] == "partition:node0"
            assert sum(n.leases.n_fences for n in nodes) == sum(
                n.leases.n_fences for n in ref_net._nodes.values()) > 0
        elif needs == "merge":
            assert port["commute_oneways"] > 0 and port["merged_deltas"] > 0
    finally:
        ref_net.shutdown()
        port_net.shutdown()


def test_simnet_replays_byte_identical_in_the_port():
    a = port_sweep.run_seed(9, node_faults=True, restarts=True)
    b = port_sweep.run_seed(9, node_faults=True, restarts=True)
    assert a["trace"] == b["trace"] and a["balances"] == b["balances"]


# ---------------------------------------------------------------------------
# tests/test_net_equivalence.py's schedule: in-process and under simnet
# ---------------------------------------------------------------------------
def test_equivalence_schedule_inproc_and_sim_equal_the_reference():
    """In-process and under simnet the waits are deterministic, so the
    trace is compared whole: outcomes, values and ``t.stats.waits``."""
    import test_net_equivalence as ref_mod
    port_mod = port_of("tests/test_net_equivalence.py")
    reg, down = ref_mod._topology_inproc()
    try:
        want, want_state = ref_mod._run_schedule(reg)
    finally:
        down()
    reg, down = port_mod._topology_inproc()
    try:
        got, got_state = port_mod._run_schedule(reg)
    finally:
        down()
    assert got == want and got_state == want_state == (921, 0, 0)
    for seed in (42, 7):
        ref_trace, ref_state, ref_sched = ref_mod._run_schedule_sim(seed)
        trace, state, sched = port_mod._run_schedule_sim(seed)
        assert trace == ref_trace == want
        assert state == ref_state == (921, 0, 0)
        assert as_reference(sched) == ref_sched


# ---------------------------------------------------------------------------
# The baselines: SVA, TFA, 2PL
# ---------------------------------------------------------------------------
def _cell_class(core):
    class Cell:
        def __init__(self, v=0):
            self.v = v

        @core.access(core.Mode.READ)
        def get(self):
            return self.v

        @core.access(core.Mode.UPDATE)
        def add(self, d):
            self.v += d

        @core.access(core.Mode.WRITE)
        def put(self, v):
            self.v = v
    return Cell


FRAMEWORKS = ["sva", "tfa"] + [f"lock-{k}-{s}" for k in ("mutex", "rw")
                               for s in ("strict", "early")] + [
    "lock-glock-strict"]


def _baseline_schedule(core, framework):
    """A fixed sequential schedule through one baseline: commits, a body
    that raises, a manual abort where the framework has one, writes then
    reads, and (TFA) a conflict forced by a transaction that commits
    inside another's body. Returns the trace and the final state."""
    Cell = _cell_class(core)
    reg = core.Registry()
    node = reg.add_node("n")
    a, b = (reg.bind("a", Cell(10), node=node),
            reg.bind("b", Cell(0), node=node))
    if framework == "sva":
        make = lambda: core.SvaTransaction(reg)  # noqa: E731
    elif framework == "tfa":
        make = lambda: core.TfaTransaction(reg)  # noqa: E731
    else:
        _, kind, mode = framework.split("-")
        make = lambda: core.LockTransaction(  # noqa: E731
            reg, kind=kind, strict=mode == "strict")
    trace = []

    def record(tag, body, declare):
        t = make()
        proxies = declare(t)
        try:
            out = t.start(lambda tt: body(tt, *proxies))
            outcome = "commit"
        except core.AbortError as e:
            out, outcome = None, "forced-abort" if e.forced else "abort"
        except ValueError as e:
            out, outcome = None, f"raised {e}"
        s = t.stats
        trace.append((tag, outcome, out, s.reads, s.writes, s.updates,
                      s.aborts, s.retries))

    both = lambda t: (t.accesses(a), t.accesses(b))  # noqa: E731

    def transfer(t, pa, pb):
        pa.add(-4)
        pb.add(4)
        return pa.get(), pb.get()
    record("transfer", transfer, both)

    def raises(t, pa, pb):
        pa.add(-100)
        raise ValueError("insufficient funds")
    record("raises", raises, both)
    if framework == "sva":
        def doomed(t, pa, pb):
            pa.add(-50)
            t.abort()
        record("abort", doomed, both)

    def overwrite(t, pa, pb):
        pb.put(pa.get() * 2)
        return pb.get()
    record("overwrite", overwrite, both)
    if framework == "tfa":
        fired = []

        def conflicted(t, pa, pb):
            v = pa.get()
            if not fired:           # a writer commits under our read
                fired.append(1)
                w = core.TfaTransaction(reg)
                wa = w.accesses(a)
                w.start(lambda _w: wa.put(v + 1))
            pb.put(v)
            return v
        record("conflict", conflicted, both)
    state = (a.holder.obj.v, b.holder.obj.v)
    reg.shutdown()
    return trace, state


@pytest.mark.parametrize("framework", FRAMEWORKS)
def test_baseline_schedule_equals_the_reference(framework):
    want = _baseline_schedule(rcore, framework)
    got = _baseline_schedule(pcore, framework)
    assert got == want
    assert got[0][0][1] == "commit"


BASELINE_TESTS = ["test_sva_basic_and_early_release",
                  "test_sva_manual_abort_cascades",
                  "test_lock_frameworks_serialize_correctly[mutex-True]",
                  "test_lock_frameworks_serialize_correctly[mutex-False]",
                  "test_lock_frameworks_serialize_correctly[rw-True]",
                  "test_lock_frameworks_serialize_correctly[rw-False]",
                  "test_lock_frameworks_serialize_correctly[glock-True]",
                  "test_rw_lock_allows_parallel_readers",
                  "test_tfa_conflict_abort_and_retry",
                  "test_tfa_read_snapshot_consistency"]


@pytest.mark.parametrize("name", BASELINE_TESTS)
def test_reference_baseline_test_passes_on_the_port(name):
    """tests/test_core_baselines.py's concurrent schedules, run on the
    port's baselines: the same final states and orderings it asserts."""
    mod = port_of("tests/test_core_baselines.py")
    fn_name, _, params = name.partition("[")
    reg = pcore.Registry()
    reg.add_node("n")
    try:
        args = [reg]
        if params:
            kind, strict = params.rstrip("]").split("-")
            args += [kind, strict == "True"]
        getattr(mod, fn_name)(*args)
    finally:
        reg.shutdown()


def test_core_exports_the_baselines():
    for name in ("SvaTransaction", "TfaTransaction", "LockTransaction",
                 "GLOBAL_LOCK", "RWLock"):
        assert getattr(pcore, name).__module__.replace(
            "repro_torch.", "repro.") == getattr(rcore, name).__module__
    assert sorted(pcore.__all__) == sorted(rcore.__all__)


# ---------------------------------------------------------------------------
# obs.export: the same Chrome-trace JSON for the same seeded run
# ---------------------------------------------------------------------------
@pytest.fixture()
def _tracing_off_after():
    yield
    for tx in (rtxtrace, ptxtrace):
        tx.disable()
        tx.reset()


def _traced_seed(sweep, txtrace, export, tmp_path, tag, seed, kw):
    txtrace.reset()
    txtrace.enable()
    try:
        sweep.run_seed(seed, **kw)
    finally:
        txtrace.disable()
    out = tmp_path / f"{tag}.json"
    n = export.write_trace(str(out))
    txtrace.reset()
    return n, out.read_text()


@pytest.mark.parametrize("seed,kw", [(3, dict(faults=False)),
                                     (2, dict(faults=False, commute=True))],
                         ids=["mixed", "commute"])
def test_export_gives_the_same_chrome_trace(tmp_path, _tracing_off_after,
                                            seed, kw):
    n_ref, ref = _traced_seed(ref_sweep, rtxtrace, rexport, tmp_path, "ref",
                              seed, kw)
    n_port, port = _traced_seed(port_sweep, ptxtrace, pexport, tmp_path,
                                "port", seed, kw)
    assert n_port == n_ref > 0
    assert as_reference(port) == ref
    evs = json.loads(port)["traceEvents"]
    assert any(e["ph"] in ("s", "t") for e in evs)      # flows survived
