"""``torch.profiler`` trace of a deck command.

Port of ``cmad_tpu/util/profiling.py``: a deck opts in with ``output:
{profile trace: <dir>}``, and every command's work then runs under one
``torch.profiler`` capture (the CPU, and the card's kernels through
CUPTI when one is in use), exported as a Chrome trace (Perfetto reads
it) into that directory.
"""
from __future__ import annotations

import contextlib
from pathlib import Path


@contextlib.contextmanager
def maybe_trace(resolved_deck: dict | None):
    """Run the enclosed work under a profiler trace when the deck's
    output section names a trace directory; no-op otherwise."""
    trace_dir = None
    if resolved_deck:
        trace_dir = resolved_deck.get("output", {}).get("profile trace")
    if trace_dir is None:
        yield None
        return
    import torch

    path = Path(trace_dir)
    path.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(str(path / "trace.json"))

