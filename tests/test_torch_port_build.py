"""The kernel library's first build when two processes start it at once
(``kernels/_lib.py::build``), on the CPU. ``nvcc`` is replaced by a script
that writes each output in two halves with a pause between, and marks each
object with the process that built it. The second process starts while
the first is still compiling: had it compiled over the first one's
objects, the first would link objects whose halves come from two
processes."""
import multiprocessing
import re
import sys
import time

from gaussianformer_tpu_torch.kernels import _lib

PAUSE = 0.6
FAKE_NVCC = f"""#!{sys.executable}
import os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "-shared" in args:
    data = b"".join(open(o, "rb").read() for o in args[args.index("-o") + 2:])
else:
    who = str(os.getppid()).encode()
    src = open(args[args.index("-c") + 1], "rb").read()
    data = b"BEGIN " + who + b" " + src + b" END " + who + bytes([10])
with open(out, "wb") as f:
    f.write(data[:len(data) // 2])
    f.flush()
    time.sleep({PAUSE})
    f.write(data[len(data) // 2:])
"""
OBJECT = re.compile(rb"BEGIN (\d+) (.*?) END (\d+)\n", re.S)


def _build(csrc, build_dir, nvcc, start, delay, results):
    """One process's first build (a spawned worker: set up here, then
    started with the other at ``start``, a barrier)."""
    _lib.CSRC_DIR, _lib.BUILD_DIR = csrc, build_dir
    _lib._nvcc = lambda: nvcc
    start.wait()
    time.sleep(delay)
    path = _lib.build()
    results.put((str(path), path.read_bytes()))


def _objects(data):
    """The sources of a library's objects in link order, if each object
    was written whole by one process; else None."""
    objs = list(OBJECT.finditer(data))
    if (b"".join(m.group(0) for m in objs) != data
            or any(m.group(1) != m.group(3) for m in objs)):
        return None
    return [m.group(2) for m in objs]


def test_concurrent_first_builds_return_whole_libraries(tmp_path,
                                                        monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    sources = {"a.cu": b"kernel a " * 50, "b.cu": b"kernel b " * 70,
               "c.cu": b"kernel c " * 30}
    for name, body in sources.items():
        (csrc / name).write_bytes(body)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    build_dir = tmp_path / "_build"

    ctx = multiprocessing.get_context("spawn")
    start, results = ctx.Barrier(2), ctx.Queue()
    procs = [ctx.Process(target=_build, args=(csrc, build_dir, str(nvcc),
                                              start, delay, results))
             for delay in (0.0, PAUSE / 2)]
    for p in procs:
        p.start()
    got = [results.get(timeout=120) for _ in procs]
    for p in procs:
        p.join(timeout=60)
        assert p.exitcode == 0
    assert got[0][0] == got[1][0]
    for _, data in got:
        assert _objects(data) == [sources[n] for n in sorted(sources)]
    # a later process loads the library without building
    monkeypatch.setattr(_lib, "CSRC_DIR", csrc)
    monkeypatch.setattr(_lib, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_lib, "_nvcc", lambda: "/nonexistent/nvcc")
    assert str(_lib.build()) == got[0][0]
