"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (``benchmark/configs/<name>.json``)
and a traffic file (``benchmark/traffic/<name>.json``, whose ``"loop"``
names the generator ``benchmark/loops/<loop>.py``); its limits are
``benchmark/checks/<workload>.json`` (with, for a train cell, how many
steps the reference follows, where not the traffic's) and each per-layer
metric is read by ``benchmark/metrics/<metric>.py``. The run sets up the program and its
inputs from the seed, warms up the cell's own shapes, measures for
``--seconds``, then checks the timed path's outputs against the plain
reference (``reference/``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checked``: each number
compared with its limit, which also end standard error.

Exits with 2, printing no result, without CUDA or with fewer cards than
the cell asks for; with 3 when JAX, flax or the JAX package are loaded at
the end of the window."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "gaussianformer_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    c: dict                  # the configuration as run (its file's config)
    cfg: object              # the program's config object
    traffic: dict
    limits: dict
    seed: int
    device: str
    shapes: dict             # parameter name -> shape


def load_json(path: Path):
    return json.loads(path.read_text())


def jsonable(x):
    if isinstance(x, dict):
        return {k: jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    return x


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def spec(name: str):
    """(workload entry, BENCHMARK.json) of ``name``."""
    bench = load_json(ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        if w["name"] == name:
            return w, bench
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


#: the key of a checks file that is no limit: how many of a train cell's
#: first steps the reference follows, where not the traffic's ``checked``
STEPS = "steps_followed"


def with_checks(traffic: dict, checks: dict) -> tuple:
    """(traffic, limits) of a cell from its traffic file and its checks
    file: the checks' ``steps_followed``, where given, is the traffic's
    ``checked``; every other key is a number's limit."""
    limits = {k: v for k, v in checks.items() if k != STEPS}
    if STEPS in checks:
        traffic = dict(traffic, checked=checks[STEPS])
    return traffic, limits


def e2e_value(name: str, metrics: dict):
    """The window's value of the end-to-end metric ``name``: its own, or
    for a split ``<metric>.<part>`` (one quantity under a bound of its own
    in the cells that it lists) ``<metric>``'s; None where it has none."""
    if name in metrics:
        return metrics[name]
    return metrics.get(name.split(".")[0]) if "." in name else None


def make_cell(workload: dict, seed: int, device: str) -> Cell:
    """The cell's configuration (checked against the program's config of
    the same name: the file holds the configuration as it is run),
    traffic and limits."""
    from gaussianformer_tpu_torch.configs import get_config
    from .reference.model import state_shapes
    conf = load_json(HERE / "configs" / f"{workload['config']}.json")
    cfg = get_config(conf["port_config"])
    run_as = jsonable(dataclasses.asdict(cfg))
    if run_as != conf["config"]:
        diff = sorted(k for k in run_as if run_as[k] != conf["config"].get(k))
        raise SystemExit(f"{workload['config']}: the program's config "
                         f"differs from the file in {diff}")
    traffic, limits = with_checks(
        load_json(HERE / "traffic" / f"{workload['traffic']}.json"),
        load_json(HERE / "checks" / f"{workload['name']}.json"))
    return Cell(name=workload["name"], c=conf["config"], cfg=cfg,
                traffic=traffic, limits=limits, seed=seed, device=device,
                shapes=state_shapes(conf["config"]))


def compare(cell: Cell, window) -> dict:
    """The numbers compared, from the plain reference run after the
    program's state is freed."""
    import torch
    from . import check, synth
    from .reference.model import Model, TrainStep
    c = cell.c
    train = cell.traffic["loop"] == "train"
    ref = Model(c, checkpoint=train).to(cell.device)
    ref.load_state_dict(synth.make_state(cell.shapes, c, cell.seed,
                                         cell.device), strict=True)
    data = window.check
    if not train:
        return check.check_frame(ref, data["capture"], data["sample"],
                                 data["draws"], data["labels"])
    step = TrainStep(ref, cell.traffic["schedule_steps"])
    with torch.enable_grad():
        return check.check_train(ref, step,
                                 check.moved(data["sut"], cell.device),
                                 data["ring"])


def read_metric(name: str, ctx: dict):
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(ctx)


def applies(entry: dict, cell: str, reported=None) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return reported is None or entry["moves"] in reported


def run_cell(cell: Cell, bench: dict, seconds: float, trace_on: bool):
    """Measure, check, and return the result line's object."""
    import torch
    from . import loops
    from .work.flops import model_work
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    window = loops.find(cell.traffic["loop"])(cell, seconds, trace_on,
                                              T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded at the end of the window: {bad}", file=sys.stderr)
        raise SystemExit(3)
    e2e = [m for m in bench["end_to_end"] if applies(m, cell.name)
           and e2e_value(m["name"], window.metrics) is not None]
    metrics = {}
    if not trace_on:
        metrics = {m["name"]: {"value": e2e_value(m["name"], window.metrics),
                               "unit": m["unit"]} for m in e2e}
    cuda = torch.device(cell.device).type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": window.memory_peak_bytes}
    out = {}
    if trace_on:
        prof = window.profile or {}
        ctx = {"loop": cell.traffic["loop"], "spans": window.spans,
               "count": window.count, "wall_s": window.wall_s,
               "profile": prof, "work": model_work(cell.c), "c": cell.c}
        reported = {m["name"] for m in e2e}
        for m in bench["per_layer"]:
            if applies(m, cell.name, reported):
                value = read_metric(m["name"], ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if prof.get("busy_s"):
            device["busy_s"] = prof["busy_s"]
            device["window_s"] = prof["window_s"]
            out["breakdown"] = {"device_ops": prof["device_ops"],
                                "idle_gaps": prof["idle_gaps"]}
        else:
            print("the profiler recorded no device operation: busy time, "
                  "idle share and breakdown not measured", file=sys.stderr)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = compare(cell, window)
    checked = {k: {"value": numbers[k], "limit": limit}
               for k, limit in cell.limits.items()}
    correct = window.failed == 0 and all(
        v["value"] <= v["limit"] for v in checked.values())
    result = {"correct": correct, "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics, "device": device,
              **out, "checked": checked}
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ns = ap.parse_args(argv)
    workload, bench = spec(ns.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < workload["chips"]):
        print(f"{ns.workload} needs {workload['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # the program's kernels build under its own checkout directory
    # (gaussianformer_tpu_torch/_build); any other compiler cache stays in
    # the checkout too
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    cell = make_cell(workload, ns.seed, "cuda")
    result = run_cell(cell, bench, ns.seconds, bool(ns.trace))
    for k, v in result["checked"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
