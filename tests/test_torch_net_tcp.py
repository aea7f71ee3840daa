"""The port's OptSVA-CF wire over real TCP sockets (CPU): the reference's
transport-equivalence and commute schedules, the reference's own
transport, pipeline and fusion tests run on the port's node servers, and
``repro_torch.dtm``'s quickstart on spawned server processes.

Over TCP a transaction's ``stats.waits`` is left out of the comparison with
the in-process trace: whether a first open finds its object still held
depends on when the home node has processed the previous transaction's
release one-ways, which the schedule does not order. In-process and under
simnet (tests/test_torch_net_parity.py) the waits are compared too. The
schedules' node servers here suspect a silent client after 60 s, not the
reference topologies' 5 s: on a loaded host a starved client can look
crashed for seconds, and the monitor's rollback then aborts a transaction
the schedule expects to commit.
"""
import pytest
import torch

from repro_torch.core import Registry, Transaction
from repro_torch.dtm import bind, connect, spawn_server
from repro_torch.net.demo import Account, HotAccount
from repro_torch.net.server import NodeServer
from torch_port import port_of

# The reference's TCP test modules, run on the port: their fixtures
# (in-process port node servers, stopped in the fixtures' finalizers) and
# their tests under a ``test_port_`` name. The client's logger is named
# for its package.
_transport = port_of("tests/test_net_transport.py")
_pipeline = port_of("tests/test_net_pipeline.py", {
    'logger="repro.net.client"': 'logger="repro_torch.net.client"'})
_fusion = port_of("tests/test_net_fusion.py")
cluster = _transport.cluster
server = _pipeline.server
for _mod in (_transport, _pipeline, _fusion):
    for _name in dir(_mod):
        if _name.startswith("test_"):
            globals()["test_port_" + _name[5:]] = getattr(_mod, _name)
del _mod, _name


def _outcomes(trace):
    return [entry[:3] for entry in trace]


@pytest.fixture()
def tcp_registry():
    """``make(bindings)``: port node servers (one per distinct node index in
    ``bindings``, a list of (name, node index, object)) and a client
    registry that has located every binding. Everything is shut down in
    the finalizer."""
    opened = []

    def make(bindings):
        n = 1 + max(i for _, i, _ in bindings)
        servers = [NodeServer(f"n{i}", monitor_timeout=60.0).start()
                   for i in range(n)]
        opened.extend(servers)
        reg = Registry()
        opened.insert(0, reg)
        nodes = [reg.connect(srv.address) for srv in servers]
        for name, i, obj in bindings:
            nodes[i].bind(name, obj)
        for srv in servers:
            reg.connect(srv.address)
        return reg

    yield make
    for thing in opened:
        (thing.shutdown if isinstance(thing, Registry) else thing.stop)()


def test_equivalence_schedule_over_tcp_equals_the_reference(tcp_registry):
    """tests/test_net_equivalence.py's schedule on two in-process port node
    servers (its ``_topology_tcp`` layout): the same outcomes and values as
    the reference in-process, and the same final state."""
    import test_net_equivalence as ref_mod
    port_mod = port_of("tests/test_net_equivalence.py")
    reg, down = ref_mod._topology_inproc()
    try:
        want, want_state = ref_mod._run_schedule(reg)
    finally:
        down()
    reg = tcp_registry([("A", 0, Account(1000)), ("B", 1, Account(500)),
                        ("C", 0, Account(0))])
    got, got_state = port_mod._run_schedule(reg)
    assert _outcomes(got) == _outcomes(want)
    assert got_state == want_state == (921, 0, 0)


def test_commute_schedule_over_tcp_and_sim_equals_the_reference(
        tcp_registry):
    import test_net_commute as ref_mod
    port_mod = port_of("tests/test_net_commute.py")
    want, want_state = ref_mod._schedule_inproc()
    got_t, state_t = port_mod._run_commute_schedule(
        tcp_registry([("H", 0, HotAccount(100))]))
    got_s, state_s = port_mod._schedule_sim()
    assert port_mod._schedule_inproc() == (want, want_state)
    assert got_s == want and _outcomes(got_t) == _outcomes(want)
    assert state_t == state_s == want_state == 132


@pytest.fixture()
def two_servers():
    servers = []
    try:
        for i in range(2):
            servers.append(spawn_server(f"dtm{i}", startup_timeout=30.0))
        yield servers
    finally:
        for s in servers:
            s.stop()


def test_dtm_quickstart_on_spawned_servers(two_servers):
    """The README's quickstart on two node-server processes: spawn,
    connect, bind, transact (an exact transfer across the nodes, then
    commute-restricted deposits that merge as deltas)."""
    for s in two_servers:
        assert "repro_torch.net.server" in s.proc.args
    addresses = [s.address for s in two_servers]
    reg = connect(*addresses)
    try:
        n0, n1 = (next(n for n in reg.nodes if n.address == a)
                  for a in addresses)
        bind(n0, "a", Account(100))
        bind(n1, "b", Account(0))
        bind(n1, "hot", HotAccount(0))
        connect(*addresses, registry=reg)
        t = Transaction(reg)
        a, b = t.updates(reg.locate("a"), 1), t.updates(reg.locate("b"), 1)
        t.start(lambda _t: (a.withdraw(30), b.deposit(30)))
        for amount in (1, 2, 3):
            t = Transaction(reg)
            hot = t.commutes(reg.locate("hot"), 1)
            t.start(lambda _t, h=hot, d=amount: h.deposit(d))
        assert [reg.locate(n).raw_call("balance") for n in ("a", "b", "hot")
                ] == [70, 30, 6]
    finally:
        reg.shutdown()


def test_chip_smoke_net_helpers_on_the_cpu():
    """chip_smoke.py's phase_net at a small size on in-process port node
    servers: its copy of the schedule gives the reference's in-process
    trace on every transport (waits left out over TCP), and its round trip
    of parameter pieces comes back bit for bit."""
    import chip_smoke
    import test_net_equivalence as ref_mod
    from repro_torch.models import Backbone, LayerGroup, ModelConfig

    reg, down = ref_mod._topology_inproc()
    try:
        want, want_state = ref_mod._run_schedule(reg)
    finally:
        down()
    servers = [NodeServer(f"s{i}", monitor_timeout=60.0).start()
               for i in range(2)]
    try:
        runs = chip_smoke.net_schedules([s.address for s in servers])
        assert runs["inproc"] == runs["sim"] == (want, want_state)
        assert _outcomes(runs["tcp"][0]) == _outcomes(want)
        assert runs["tcp"][1] == want_state
        cfg = ModelConfig(name="net", family="dense", d_model=64, n_heads=4,
                          n_kv_heads=2, d_ff=128, vocab=512,
                          groups=(LayerGroup(("attn",), 2),))
        bb = Backbone(cfg, param_dtype=torch.float32, device="cpu")
        old = chip_smoke.net_pieces(bb.init(0), 64 * 1024)
        new = chip_smoke.net_pieces(bb.init(1), 64 * 1024)
        assert [n for n, _ in new][:3] == ["['embed']['tok']#0",
                                            "['embed']['tok']#1",
                                            "['final_norm']#0"]
        assert all(p.numel() * 4 <= 64 * 1024 for _, p in new)
        creg = connect(servers[0].address)
        try:
            node, = creg.nodes
            rt = chip_smoke.net_round_trip(creg, node, old, new, "cpu")
        finally:
            creg.shutdown()
        assert rt["bitwise"] and rt["cells"] == len(new) == 12
    finally:
        for s in servers:
            s.stop()
