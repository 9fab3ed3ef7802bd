"""The port's tracing (``gaussianformer_tpu_torch/utils/profiling.py``) on
the CPU: spans nest, with parents and self times right on a hand-built
tree (a fake clock and fake CUDA events); off means no record and one
shared null context; a tensor counter is read once, in ``collect()``; the
launch counters keep their meaning; a tiny frame and a tiny train step with
tracing on record every span the program places (``BEVSegmentor``, the
lifter, the encoder's spconv and deformable aggregation, the head's
binning and splat, every DCN and its backward, the splat's backward, the
step's phases), with no device time on the CPU; the splat's backward runs
once for each refine layer a step supervises; and labels, loss and
gradients are the same bits with tracing on and off.

Two cases need the card (marker ``cuda``): an eager tiny frame and train
step under ``torch.cuda.set_sync_debug_mode("error")``, which only
``host_read`` lifts, so every synchronisation on the path is one of its
reads; and ``bench.pipeline``'s CUDA graph captured with tracing on. On the
card (``--noconftest``: tests/conftest.py imports JAX):
``python -m pytest --noconftest tests/test_torch_port_tracing.py -m cuda``.
"""
import contextlib
import dataclasses

import pytest
import torch

from gaussianformer_tpu_torch import profile_forward
from gaussianformer_tpu_torch.configs import get_config
from gaussianformer_tpu_torch.data.synthetic import synthetic_batch
from gaussianformer_tpu_torch.kernels import _lib
from gaussianformer_tpu_torch.models.segmentor import build_segmentor
from gaussianformer_tpu_torch.train.optim import build_optimizer
from gaussianformer_tpu_torch.train.step import build_loss, train_step
from gaussianformer_tpu_torch.utils import profiling

FRAME_SPANS = {"forward", "towers", "dcn", "lifter", "encoder",
               "encoder/spconv", "encoder/deformable", "head", "head/bins",
               "head/splat"}
PROB_SPANS = {"lifter/tower", "lifter/fps"}
STEP_SPANS = {"step", "step/forward", "step/losses", "step/backward",
              "dcn_bwd", "splat_bwd", "step/clip", "step/update"}
PARENTS = {"forward": {None, "step/forward"}, "towers": {"forward"},
           "dcn": {"towers", "lifter/tower"}, "lifter": {"forward"},
           "lifter/tower": {"lifter"}, "lifter/fps": {"lifter"},
           "encoder": {"forward"}, "encoder/spconv": {"encoder"},
           "encoder/deformable": {"encoder"}, "head": {"forward"},
           "head/bins": {"head"}, "head/splat": {"head"}, "step": {None},
           "step/forward": {"step"}, "step/losses": {"step"},
           "step/backward": {"step"}, "dcn_bwd": {"step/backward"},
           "splat_bwd": {"step/backward"}, "step/clip": {"step"},
           "step/update": {"step"}}


@pytest.fixture(autouse=True)
def _off():
    yield
    profiling.disable()


@pytest.fixture
def fake_card(monkeypatch):
    """A clock that moves 1 ms a reading, and CUDA events that read a
    device clock the test sets, so that spans get host and device times
    on the CPU."""
    clock = {"host": 0, "device": 0.0}

    def perf_counter_ns():
        clock["host"] += 1_000_000
        return clock["host"]

    class Event:
        def __init__(self, enable_timing=False):
            self.t = None

        def record(self):
            self.t = clock["device"]

        def elapsed_time(self, end):
            return end.t - self.t

    monkeypatch.setattr(profiling.time, "perf_counter_ns", perf_counter_ns)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    profiling.enable()
    profiling._STATE["events"] = True
    return clock


def test_spans_nest_with_parents_and_self_times(fake_card):
    """a(b, c(d)) then a again: each span's parent, its top-level call,
    and host and device times with and without its children."""
    span = profiling.span
    with span("a"):
        fake_card["device"] += 1.0
        with span("b"):
            fake_card["device"] += 2.0
        with span("c"):
            fake_card["device"] += 4.0
            with span("d"):
                fake_card["device"] += 8.0
    with span("a"):
        fake_card["device"] += 16.0
    profiling.disable()
    got = profiling.collect()
    assert got["calls"] == 2
    s = got["spans"]
    assert {k: v["calls"] for k, v in s.items()} == {"a": 2, "b": 1, "c": 1,
                                                      "d": 1}
    assert {k: v["device_ms"] for k, v in s.items()} == {
        "a": 31.0, "b": 2.0, "c": 12.0, "d": 8.0}
    assert {k: v["self_device_ms"] for k, v in s.items()} == {
        "a": 17.0, "b": 2.0, "c": 4.0, "d": 8.0}
    # each reading of the fake clock moves it 1 ms: a span without
    # children takes 1 ms, and each child adds its own and 1 ms more
    assert {k: v["host_ms"] for k, v in s.items()} == {
        "a": 7.0 + 1.0, "b": 1.0, "c": 3.0, "d": 1.0}
    assert {k: v["self_host_ms"] for k, v in s.items()} == {
        "a": 3.0 + 1.0, "b": 1.0, "c": 2.0, "d": 1.0}
    assert [(n, p, call) for n, p, call, *_ in profiling.records()] == [
        ("a", None, 1), ("b", "a", 1), ("c", "a", 1), ("d", "c", 1),
        ("a", None, 2)]


def test_spans_are_profiler_ranges_while_a_profiler_records():
    """Under ``torch.profiler`` a traced span is a ``gf/<name>`` range on
    the profiler's clock, around what it wraps; outside a profiler, and
    with tracing off, there is none."""
    act = [torch.profiler.ProfilerActivity.CPU]

    def traced():
        with profiling.span("a"):
            with profiling.span("b"):
                torch.ones(3).sum()

    profiling.enable()
    traced()                         # no profiler: no range
    with torch.profiler.profile(activities=act) as prof:
        traced()
    profiling.disable()
    with torch.profiler.profile(activities=act) as off:
        traced()
    ranges = {e.name: e for e in prof.events() if e.name.startswith("gf/")}
    assert set(ranges) == {"gf/a", "gf/b"}
    a, b = ranges["gf/a"].time_range, ranges["gf/b"].time_range
    assert a.start <= b.start <= b.end <= a.end
    assert not [e for e in off.events() if e.name.startswith("gf/")]
    assert profiling.collect()["spans"]["a"]["calls"] == 2


def test_spans_close_through_an_exception(fake_card):
    with pytest.raises(ValueError):
        with profiling.span("a"):
            with profiling.span("b"):
                raise ValueError("inside")
    with profiling.span("c"):
        pass
    assert [(n, p, call) for n, p, call, *_ in profiling.records()] == [
        ("a", None, 1), ("b", "a", 1), ("c", None, 2)]


def test_off_records_nothing():
    """Off: every span is one shared null context, counters and reads
    leave no record, and ``collect`` has nothing."""
    profiling.enable()
    profiling.disable()
    assert not profiling.enabled()
    assert profiling.span("a") is profiling.span("b") is profiling._NULL
    with profiling.span("a"):
        profiling.count("n", 3)
        profiling.count("t", torch.ones(2))
        assert profiling.host_read("r", torch.tensor(5)) == 5
    assert profiling.collect() == {"spans": {}, "counters": {},
                                   "launches": {}, "calls": 0}
    assert profiling.records() == []


def test_tensor_counter_read_once_at_collect(monkeypatch):
    """A tensor counter is summed on its device: no host read while
    counting (every way to read one raises here), one in ``collect``."""
    profiling.enable()
    with monkeypatch.context() as m:
        def boom(*a, **k):
            raise AssertionError("a host read while counting")
        for name in ("item", "tolist", "__int__", "__float__", "__bool__",
                     "__index__", "cpu", "numpy"):
            m.setattr(torch.Tensor, name, boom)
        profiling.count("entries", torch.tensor([7], dtype=torch.int32))
        profiling.count("entries", torch.tensor([5], dtype=torch.int32))
        profiling.count("mass", torch.tensor([0.25, 0.5]))
        profiling.count("mass", 1)
        profiling.count("calls", 2)
        profiling.count("calls", 3)
    reads = []
    real = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist",
                        lambda t: reads.append(1) or real(t))
    got = profiling.collect()["counters"]
    assert got == {"entries": 12, "mass": 1.75, "calls": 5}
    assert isinstance(got["entries"], int)
    assert len(reads) == 1


def test_host_read_counts_and_spans_each_read():
    assert profiling.host_read("x", torch.tensor([3])) == 3
    profiling.enable()
    assert profiling.host_read("flags", torch.tensor(2)) == 2
    assert profiling.host_read("flags", torch.tensor([1, 2])) == [1, 2]
    assert profiling.host_read("cap", torch.tensor(1.5)) == 1.5
    got = profiling.collect()
    assert got["counters"] == {"host_syncs": 3}
    assert {k: v["calls"] for k, v in got["spans"].items()} == {
        "sync/flags": 2, "sync/cap": 1}


def test_launches_keep_their_meaning(monkeypatch):
    """``collect`` gives each kernel's launches since ``enable`` from the
    wrappers' own counters, which tracing neither resets nor adds to."""
    monkeypatch.setitem(_lib.LAUNCHES, "dcn", 4)
    monkeypatch.setitem(_lib.LAUNCHES, "splat", 1)
    profiling.enable()
    _lib.LAUNCHES["dcn"] += 3
    with profiling.span("a"):
        profiling.count("n", 1)
    assert profiling.collect()["launches"] == {"dcn": 3}
    assert _lib.LAUNCHES["dcn"] == 7 and _lib.LAUNCHES["splat"] == 1


def test_profile_forward_reads_the_program_spans():
    """One tracing system: ``profile_forward`` keeps no timer of its own,
    and keeps the profiler helpers ``chip_smoke.py`` imports."""
    assert not hasattr(profile_forward, "StageTimer")
    assert profile_forward.profiling is profiling
    assert callable(profile_forward.device_busy_ms)
    assert callable(profile_forward.device_kernels)


def _tiny(name, device="cpu"):
    """A tiny config's model and batch; on the card its towers compute in
    bf16, which the DCN kernels take."""
    cfg = get_config(name)
    if device != "cpu":
        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    g = cfg.grid
    model = build_segmentor(cfg, device=device, seed=0)
    batch = synthetic_batch(1, cfg.input_size, (g.H, g.W, g.D), seed=0,
                            device=device)
    return cfg, model, batch


def _frame(model, batch, seed=0):
    with torch.inference_mode():
        return model(batch["imgs"], batch["projection_mat"],
                     batch["image_wh"], batch["occ_xyz"],
                     generator=torch.Generator(
                         batch["imgs"].device).manual_seed(seed),
                     occ_only=True)["final_occ"]


def _stepper(cfg, model):
    """A train step of ``model`` on a batch from a generator of a seed,
    with one AdamW across calls."""
    opt, schedule = build_optimizer(model, cfg, 10)
    loss_fn = build_loss(cfg)

    def step(batch, seed=0):
        gen = torch.Generator(batch["imgs"].device).manual_seed(seed)
        return train_step(model, opt, schedule, loss_fn, batch, gen)
    return step


@pytest.mark.parametrize("name", ["prob_gs6400_tiny", "gs144000_tiny",
                                  "gs25600_solid_tiny"])
def test_tiny_frame_and_step_record_every_span(name):
    cfg, model, batch = _tiny(name)
    profiling.enable()
    _frame(model, batch)
    _stepper(cfg, model)(batch)
    profiling.disable()
    got = profiling.collect()
    want = FRAME_SPANS | STEP_SPANS | (PROB_SPANS if cfg.version == 2
                                       else set())
    assert set(got["spans"]) == want
    assert got["calls"] == 2
    assert all(s["device_ms"] is None and s["self_device_ms"] is None
               for s in got["spans"].values())
    assert all(s["host_ms"] >= s["self_host_ms"] >= 0
               for s in got["spans"].values())
    assert got["spans"]["forward"]["calls"] == 2
    assert got["spans"]["step/backward"]["calls"] == 1
    recs = profiling.records()
    for n, parent, *_ in recs:
        assert parent in PARENTS[n], (n, parent)
    first_step = next(i for i, r in enumerate(recs) if r[0] == "step")
    assert {r[2] for r in recs[:first_step]} == {1}
    assert {r[2] for r in recs[first_step:]} == {2}
    # the CPU runs the plain versions: no kernel launch, no bins, no read.
    # The frame's frozen BNs run in the epilogue (the DCN blocks' bn2 in
    # K1's), the step's in PyTorch: 17 a ResNet-26 tower, 4 in SECONDFPN
    towers, fpn = (2, 4) if cfg.version == 2 else (1, 0)
    dcn = sum(cfg.stage_with_dcn)
    assert got["launches"] == {}
    assert got["counters"] == {"bn_fused": towers * (17 - dcn) + fpn,
                               "bn_eager": towers * 17 + fpn}


@pytest.mark.parametrize("name,calls", [("gs25600_solid_tiny", 1),
                                        ("gs144000_tiny", 2)])
def test_step_splat_backward_once_a_supervised_layer(name, calls):
    """``splat_bwd`` (K7) runs once for each refine layer a step splats:
    the last alone under ``random_1`` (gs25600_solid), every one of the
    ``num_decoder`` under ``all`` (gs144000)."""
    cfg, model, batch = _tiny(name)
    assert calls == (1 if cfg.apply_loss_type == "random_1"
                     else cfg.num_decoder)
    step = _stepper(cfg, model)
    profiling.enable()
    step(batch)
    profiling.disable()
    got = profiling.collect()["spans"]
    assert got["splat_bwd"]["calls"] == calls
    assert got["step/backward"]["calls"] == 1


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["prob_gs6400_tiny", "gs144000_tiny"])
def test_outputs_bit_equal_with_tracing_on_and_off(name, one_thread):
    """Labels of a frame, then a train step's loss, gradient norm,
    gradients and updated parameters: the same bits either way."""
    def run(on):
        cfg, model, batch = _tiny(name)
        if on:
            profiling.enable()
        labels = _frame(model, batch)
        metrics = _stepper(cfg, model)(batch)
        profiling.disable()
        grads = {k: p.grad.clone() for k, p in model.named_parameters()
                 if p.grad is not None}
        params = {k: p.detach().clone()
                  for k, p in model.named_parameters()}
        return labels, metrics, grads, params

    off, on = run(False), run(True)
    assert profiling.records()
    assert torch.equal(off[0], on[0])
    for k in off[1]:
        assert torch.equal(off[1][k], on[1][k]), k
    assert off[2].keys() == on[2].keys() and off[2]
    for d_off, d_on in ((off[2], on[2]), (off[3], on[3])):
        for k in d_off:
            assert torch.equal(d_off[k], d_on[k]), k


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def sync_errors():
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
@pytest.mark.parametrize("on", [False, True])
def test_every_sync_of_an_eager_frame_and_step_is_a_host_read(card, on):
    """An eager tiny Prob-64 frame and train step on the card raise at any
    synchronising operation but ``host_read``'s, with tracing off and on;
    with it on, the reads are counted and the splat's bins too."""
    cfg, model, batch = _tiny("prob_gs6400_tiny", "cuda")
    step = _stepper(cfg, model)
    _frame(model, batch)
    step(batch)                 # builds the kernels and AdamW's state
    if on:
        profiling.enable()
    with sync_errors():
        labels = _frame(model, batch, 1)
        metrics = step(batch, 1)
    profiling.disable()
    assert labels.shape[0] == 1 and torch.isfinite(metrics["loss"])
    if on:
        got = profiling.collect()
        assert got["counters"]["host_syncs"] >= 2
        assert got["counters"]["splat_entries"] > 0
        assert got["counters"]["deformable_bin_entries"] > 0
        assert all(s["device_ms"] is not None
                   for s in got["spans"].values())
        assert (got["spans"]["encoder/spconv"]["device_ms"]
                < got["spans"]["encoder"]["device_ms"])


@pytest.mark.cuda
def test_cuda_graph_capture_with_tracing_on(card):
    """``bench.pipeline`` captures two tiny frames into one CUDA graph with
    tracing on: the capture records no events and reads nothing, and the
    replay gives the eager frames' labels."""
    from gaussianformer_tpu_torch import bench
    _, model, batch = _tiny("prob_gs6400_tiny", "cuda")
    profiling.enable()
    piped = bench.pipeline(model, batch, 2)
    profiling.disable()
    got = profiling.collect()
    assert got["spans"]["forward"]["calls"] >= 4
    for i, out in enumerate(piped["outs"]):
        assert torch.equal(out, piped["frame"](i))
