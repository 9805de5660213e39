"""The port's tracing (smap_tpu_torch/utils/profiling.py) on the CPU:
``StepWindowProfiler`` starts and stops at the iterations where the JAX
package's class does, ``trace`` writes a Chrome trace (or nothing without
a directory), and ``annotate`` spans land in it. The JAX class's calls
are recorded by patching ``jax.profiler.start_trace`` / ``stop_trace``
here; nothing in the JAX package changes."""

import glob
import itertools
import json
import os

import pytest
import torch

import jax

import smap_tpu.utils.profiling as jprof
from smap_tpu_torch.utils import profiling

# first_step, num_steps (0: the inert window), steps a window.
GRID = list(itertools.product((0, 1, 2, 3, 10), (0, 1, 2, 5), (1, 2, 3, 4)))
LAST_IT = 24


def _drive(make, window, events):
    prof = make()
    for it in range(window, LAST_IT + 1, window):
        events.append(("it", it))
        prof.step(it, window)
    events.append(("close",))
    prof.close()
    return events


class _FakeProfile:
    def __init__(self, events):
        self.events = events

    def start(self):
        self.events.append("start")

    def stop(self):
        self.events.append("stop")


@pytest.mark.parametrize("first,num,window", GRID)
def test_step_window_matches_jax(monkeypatch, first, num, window):
    want = []
    monkeypatch.setattr(jax.profiler, "start_trace",
                        lambda log_dir: want.append("start"))
    monkeypatch.setattr(jax.profiler, "stop_trace",
                        lambda: want.append("stop"))
    _drive(lambda: jprof.StepWindowProfiler("d", first, num), window, want)

    got = []
    monkeypatch.setattr(profiling, "_profiler",
                        lambda log_dir: _FakeProfile(got))
    _drive(lambda: profiling.StepWindowProfiler("d", first, num), window,
           got)
    assert got == want
    # One trace, or none: for an empty window, or a first step before the
    # loop's first (the start is checked after each window).
    assert want.count("start") == want.count("stop") == int(
        num > 0 and first >= 1)


def test_step_window_inert_without_a_directory(monkeypatch):
    got = []
    monkeypatch.setattr(profiling, "_profiler",
                        lambda log_dir: _FakeProfile(got))
    for log_dir in ("", None):
        _drive(lambda: profiling.StepWindowProfiler(log_dir, 1, 2), 1, [])
    assert got == []


def _traces(log_dir):
    return sorted(glob.glob(os.path.join(log_dir, "*.pt.trace.json")))


def test_trace_writes_a_chrome_trace_with_its_spans(tmp_path):
    """One file a region, named after the host and process, holding the
    ops and the annotate spans; no directory, no file."""
    with profiling.trace(None):
        torch.ones(4) + 1
    log_dir = str(tmp_path / "prof")
    with profiling.trace(log_dir):
        with profiling.annotate("paf_score"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = _traces(log_dir)
    assert len(files) == 1
    assert os.path.basename(files[0]).startswith(
        f"{profiling.socket.gethostname()}_{os.getpid()}.")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == "paf_score"]
    assert [e.get("cat") for e in spans] == ["user_annotation"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert os.listdir(tmp_path) == ["prof"]


def test_annotate_outside_a_trace():
    """No profiler: the span is skipped and the block runs."""
    with profiling.annotate("associate"):
        x = torch.ones(3) * 2
    assert x.sum() == 6


def test_step_window_writes_one_trace(tmp_path):
    log_dir = str(tmp_path / "win")
    prof = profiling.StepWindowProfiler(log_dir, first_step=2, num_steps=2)
    for it in range(1, 7):
        with profiling.annotate(f"step{it}"):
            torch.ones(4) + it
        prof.step(it)
    prof.close()
    files = _traces(log_dir)
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    # Started after step 2, stopped after step 4.
    assert {"step3", "step4"} <= names
    assert not names & {"step1", "step2", "step5", "step6"}
