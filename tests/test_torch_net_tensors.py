"""Torch state cells on the wire (CPU): a ``txstore.StateCell`` pickles its
tensor leaves as dtype, shape and host bytes and rebuilds them on the CPU
with fresh version counters; bound on a port node server, a cell's tensors
come back bit for bit over TCP, through the WAL's delta frames and across a
simulated crash and restart. Every comparison is bit for bit
(``torch.equal`` on the same dtype).
"""
import pickle
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.core import RemoteObjectFailure, Transaction
from repro_torch.dtm import bind, connect, spawn_server
from repro_torch.net import wal
from repro_torch.net.simnet import build_simnet
from repro_torch.net.transport import LocalBuf
from repro_torch.txstore.store import StateCell, TornSnapshotError
from torch_port import ROOT


def _leaves(seed, n=8):
    """fp32, bf16, int64 and 0-d leaves, made by in-place initialisers (so
    every recorded version counter is at least 1)."""
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.empty(n, 4).normal_(generator=g),
        "b": torch.empty(n).normal_(generator=g).to(torch.bfloat16),
        "ids": torch.empty(3, n, dtype=torch.int64).random_(
            -2**40, 2**40, generator=g),
        "scale": torch.empty(()).uniform_(generator=g),
        "nested": [torch.empty(2, 3).normal_(generator=g).t(),
                   (torch.zeros(0, 5, dtype=torch.bfloat16), 7)],
    }


def _assert_equal(got, want):
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want.cpu())
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_equal(a, b)
    else:
        assert got == want


# ---------------------------------------------------------------------------
# The cell's own pickling
# ---------------------------------------------------------------------------
def test_cell_pickled_after_an_inplace_init_reads_without_a_torn_error():
    """A leaf made by ``normal_`` records version 1; its unpickled copy
    starts at 0. The copy's counters are rebuilt, so ``get`` raises
    nothing."""
    w = torch.empty(16, 16).normal_()
    cell = StateCell({"w": w}, 3)
    assert cell._versions[0][1] >= 1
    copy = pickle.loads(pickle.dumps(cell))
    assert [v for _t, v in copy._versions] == [copy.value["w"]._version]
    _assert_equal(copy.get(), {"w": w})
    assert copy.get_version() == 3


@pytest.mark.parametrize("how", ["protocol4", "protocol5", "out-of-band"])
def test_cell_round_trips_bit_for_bit(how):
    tree = _leaves(0)
    cell = StateCell(tree, 5)
    if how == "out-of-band":
        bufs = []
        data = pickle.dumps(cell, protocol=5, buffer_callback=bufs.append)
        assert bufs, "tensor bytes leave the pickle stream"
        copy = pickle.loads(data, buffers=[bytes(b.raw()) for b in bufs])
    else:
        copy = pickle.loads(pickle.dumps(cell, protocol=int(how[-1])))
    _assert_equal(copy.get(), tree)
    assert copy.value["scale"].shape == ()
    # the copy's leaves are its own: changing one in place is refused
    copy.value["w"].add_(1.0)
    with pytest.raises(TornSnapshotError):
        copy.get()
    _assert_equal(cell.get(), tree)


def test_bf16_bytes_stay_out_of_band_and_exact():
    x = torch.randn(512, 512).to(torch.bfloat16)
    bufs = []
    data = pickle.dumps(StateCell(x), protocol=5, buffer_callback=bufs.append)
    assert len(data) < 1024 and [len(b.raw()) for b in bufs] == [512 * 512 * 2]
    copy = pickle.loads(data, buffers=[bytes(b.raw()) for b in bufs])
    assert torch.equal(copy.get().view(torch.int16), x.view(torch.int16))


def test_inplace_change_after_set_on_the_clients_cell_still_raises():
    cell = StateCell()
    tree = _leaves(1)
    cell.set(tree, 1)
    _assert_equal(cell.get(), tree)
    tree["nested"][0].mul_(2)
    with pytest.raises(TornSnapshotError):
        cell.get()


def test_dtensor_leaf_is_refused_by_name():
    from torch.distributed.tensor import Replicate, distribute_tensor
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = torch.distributed.device_mesh.init_device_mesh("cpu", (1,))
        d = distribute_tensor(torch.ones(4), mesh, [Replicate()])
        cell = StateCell({"layers": [{"wq": torch.ones(2)}, {"wq": d}]})
        with pytest.raises(TypeError, match=r"\['layers'\]\[1\]\['wq'\]"):
            pickle.dumps(cell)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The WAL's frames and a simulated crash
# ---------------------------------------------------------------------------
def test_wal_delta_fold_replays_a_tensor_cell_bit_for_bit():
    """``encode_delta``/``fold_payload`` (the commute-delta frames the WAL
    and the replica chain carry) fold a tensor ``set`` into the committed
    snapshot of a tensor cell; the frames survive a replay."""
    base_tree, new_tree = _leaves(2), _leaves(3)
    base = pickle.dumps(StateCell(base_tree, 1))
    delta = wal.encode_delta([("set", (new_tree, 2), {})])
    folded = wal.fold_payload(base, delta)
    assert wal.fold_payload(base, base) == base      # a snapshot replaces
    disk = wal.VirtualDisk()
    log = wal.Wal(disk)
    log.append({"kind": "snapshot", "payload": folded}, sync=True)
    records, good = wal.replay(disk.read_all())
    assert good == len(disk.read_all()) and len(records) == 1
    cell = pickle.loads(records[0]["payload"])
    _assert_equal(cell.get(), new_tree)
    assert cell.get_version() == 2


def test_sim_node_crash_and_restart_replays_a_tensor_cell():
    """A tensor cell homed on node0 with a follower on node1: a write
    transaction commits, node0 crashes and restarts from its WAL image,
    and an irrevocable read-only transaction reads the committed tensors
    back bit for bit."""
    net = build_simnet(5, 2)
    setup = net.client_registry("setup")
    n0, n1 = sorted(setup.nodes, key=lambda n: n.name)
    n0.bind("cell", StateCell(_leaves(4), 0), followers=[n1.address])
    want = _leaves(5)
    out = {}

    def client():
        reg = net.client_registry("c0")
        t = Transaction(reg)
        w = t.writes(reg.locate("cell"), 1)
        t.start(lambda _t: w.set(want, 1))
        net.crash_node_at("node0", 0.01)
        net.restart_node_at("node0", 0.03)
        reg.nodes[0].client.sleep(0.2)
        for _ in range(40):         # node0 may still be rejoining its chain
            try:
                t = Transaction(reg, irrevocable=True)
                r = t.reads(reg.locate("cell"), 2)
                t.start(lambda _t: out.update(value=r.get(),
                                              version=r.get_version()))
                return
            except RemoteObjectFailure:
                reg.nodes[0].client.sleep(0.05)

    net.spawn(client, "c0")
    net.run()
    try:
        restarted = net._nodes["node0"]
        assert restarted._recovered is not None
        assert restarted._recovered.objects
        _assert_equal(out["value"], want)
        assert out["version"] == 1
    finally:
        net.shutdown()


# ---------------------------------------------------------------------------
# Over TCP, on a spawned port node server
# ---------------------------------------------------------------------------
def test_node_server_starts_without_torch():
    code = ("import sys, repro_torch.net.server, repro_torch.dtm; "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


@pytest.fixture(scope="module")
def spawned():
    server = spawn_server("tensors0", monitor_timeout=60.0,
                          startup_timeout=30.0)
    reg = None
    try:
        reg = connect(server.address)
        yield server, reg
    finally:
        if reg is not None:
            reg.shutdown()
        server.stop()


@pytest.mark.parametrize("n", [8, 4096], ids=["piggyback", "fetched"])
def test_cell_on_a_node_server_round_trips_over_tcp(spawned, n):
    """n=8 keeps the cell's pickled state under the 64 KiB piggyback limit
    (it rides the task-done note); n=4096 puts it over (read from the home
    node). A write transaction publishes, an irrevocable read-only one
    reads back: bit for bit, no torn-snapshot error."""
    server, reg = spawned
    node, = reg.nodes
    bind(node, f"cell{n}", StateCell(_leaves(6, n), 0))
    reg.connect(server.address)
    cell = reg.locate(f"cell{n}")
    size = len(pickle.dumps(StateCell(_leaves(6, n))))
    assert (size < 64 * 1024) == (n == 8)
    want = _leaves(7, n)
    t = Transaction(reg)
    w = t.writes(cell, 1)
    t.start(lambda _t: w.set(want, 1))
    out = {}
    t = Transaction(reg, irrevocable=True)
    r = t.reads(cell, 2)
    t.start(lambda _t: out.update(value=r.get(), version=r.get_version()))
    _assert_equal(out["value"], want)
    assert out["version"] == 1
    assert isinstance(t._order[0].buf, LocalBuf) == (n == 8)
    _assert_equal(cell.raw_call("get"), want)
    assert server.proc.poll() is None
