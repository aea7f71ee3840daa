"""The rest of a run with the timed path broken underneath: the harness's
look for a card skipped (a tiny cell on the CPU), each fault of
``portbench.faults`` planted in the port, and ``correct`` comes out false;
the same run unbroken comes out true. The limits here are the tiny cells'
(fp32 on the CPU agrees to round-off), not the card's."""
import pytest

from portbench import faults
from portbench.tests import tiny

TRAIN = "qwen3-4b.train-2k"
SERVE = ["mixtral-8x22b.serve-long", "mixtral-8x22b.serve-long+drops"]


def test_train_unbroken_is_correct():
    r = tiny.run(tiny.cell(TRAIN))
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_train_fault_is_not_correct(fault):
    with faults.TRAIN[fault]():
        r = tiny.run(tiny.cell(TRAIN))
    assert not r["correct"], r["compared"]


@pytest.mark.parametrize("name", SERVE)
def test_serve_unbroken_is_correct(name):
    r = tiny.run(tiny.cell(name))
    assert r["correct"], r["compared"]
    assert r["failed"] == 0 and r["attempted"] >= 4


@pytest.mark.parametrize("fault", sorted(faults.SERVE))
@pytest.mark.parametrize("name", SERVE)
def test_serve_fault_is_not_correct(name, fault):
    with faults.SERVE[fault]():
        r = tiny.run(tiny.cell(name))
    assert not r["correct"], r["compared"]


def test_train_control_fails_the_check():
    """The reference in fp8 in the port's place reads past the tiny
    cell's limits."""
    from portbench.drivers import train
    from portbench.reference import model as ref
    cell = tiny.cell(TRAIN)
    ctx = train.build(cell, 4, "cpu")
    train.free(ctx)
    truth = train.reference(ctx)
    low = train.reference(ctx, ref.Precision("fp8"))
    numbers = train.compare(ctx, truth, low)
    limits = cell.cell["check"]["limits"]
    assert any(numbers[k] > limits[k] for k in numbers)


@pytest.mark.parametrize("name", SERVE)
def test_serve_control_fails_the_check(name):
    """The reference in fp8 in the port's place, at the tokens a tiny
    run served, comes out not correct through the readings' judgement
    (the harness's comparison at the cell's limits); the port's own
    numbers come out correct."""
    from portbench import readings
    from portbench.drivers import serve
    from portbench.reference import model as ref
    cell = tiny.cell(name)
    ctx = serve.setup(cell, tiny.SEED, "cpu")
    serve.window(ctx, 0.0, False, whole_passes=False)
    check = serve.check(ctx)
    finished = [r for r in ctx["requests"] if r.done.is_set()]
    out = readings.judged(cell, {
        "program": check["numbers"],
        "control": serve.gap_numbers(ctx, finished, ref.Precision("fp8"))},
        check["failed"])
    assert out["correct"] == {"program": True, "control": False}, out


def test_train_faults_are_judged_not_correct():
    """A fault's numbers, as the readings print them, go through the
    harness's comparison and read false; the port's read true."""
    from portbench import readings
    from portbench.drivers import train
    cell = tiny.cell(TRAIN)
    ctx = train.build(cell, 4, "cpu")
    train.first_steps(ctx)
    side = train.program_side(ctx)
    train.free(ctx)
    truth = train.reference(ctx)
    with faults.TRAIN["half_batch"]():
        bad_ctx = train.build(cell, 4, "cpu")
        train.first_steps(bad_ctx)
    bad = train.program_side(bad_ctx)
    train.free(bad_ctx)
    out = readings.judged(cell, {"program": train.compare(ctx, truth, side),
                                 "half_batch": train.compare(ctx, truth,
                                                             bad)})
    assert out["correct"] == {"program": True, "half_batch": False}, out
