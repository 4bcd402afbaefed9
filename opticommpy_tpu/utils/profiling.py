"""Per-stage timing and device profiling helpers.

The reference's only observability is wall-clock ``time.time()`` blocks in
its notebooks ("DSP execution time benchmark" cell, SURVEY.md §5) plus tqdm
bars. Here:

- :class:`StageTimer` measures named pipeline stages with correct device
  synchronization (jax dispatch is async; each stage result is block-waited),
- :func:`trace` wraps a region with the JAX/XLA profiler, producing a
  TensorBoard-loadable trace of the compiled kernels,
- :func:`device_time_by_scope` reduces such a trace to device busy time,
  idle share and per-scope kernel time, attributing each device event to
  the ``jax.named_scope`` / ``jit(...)`` names its HLO instruction carries
  (:func:`hlo_op_scopes`).
"""

import glob
import os
import re
import time
from contextlib import contextmanager

import jax

__all__ = ["StageTimer", "trace", "hlo_op_scopes", "device_time_by_scope"]


def _block(x):
    return jax.tree_util.tree_map(
        lambda v: v.block_until_ready() if hasattr(v, "block_until_ready") else v, x
    )


class StageTimer:
    """Accumulates wall-clock timings of named stages.

    >>> timer = StageTimer()
    >>> with timer("edc"):
    ...     out = timer.sync(edc(sig, cfg))
    >>> print(timer.table())
    """

    def __init__(self):
        self.times = {}

    @contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        yield
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    @staticmethod
    def sync(x):
        """Wait for all device work feeding ``x`` (use inside a stage block)."""
        return _block(x)

    def table(self):
        total = sum(self.times.values()) or 1.0
        lines = [f"{'stage':<24} {'time [s]':>10} {'share':>8}"]
        for name, t in sorted(self.times.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:<24} {t:>10.3f} {100 * t / total:>7.1f}%")
        lines.append(f"{'total':<24} {total:>10.3f}")
        return "\n".join(lines)


@contextmanager
def trace(log_dir):
    """Capture a JAX profiler trace of the enclosed region into ``log_dir``.

    View with TensorBoard (``tensorboard --logdir <log_dir>``) or Perfetto.
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


_HEADER = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_INST = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"calls=%?([\w.\-]+)")


def hlo_op_scopes(hlo_text):
    """``{instruction name: set of op_name paths}`` from compiled HLO text.

    A fusion (or any instruction with ``calls=``) also carries the op_names
    of every instruction in the computation it calls, so a fused kernel is
    attributed to all the source scopes it fuses.
    """
    own, calls, members = {}, {}, {}
    comp = None
    for line in hlo_text.splitlines():
        m = _INST.match(line)
        if m and comp is not None:
            name = m.group(1)
            members.setdefault(comp, []).append(name)
            own[name] = set(_OP_NAME.findall(line))
            calls[name] = _CALLS.findall(line)
            continue
        h = _HEADER.match(line)
        if h:
            comp = h.group(1)

    def collect(name, seen):
        out = set(own.get(name, ()))
        for c in calls.get(name, ()):
            for inner in members.get(c, ()):
                if inner not in seen:
                    seen.add(inner)
                    out |= collect(inner, seen)
        return out

    return {name: collect(name, {name}) for name in own}


def _union_ns(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


_MODULE = re.compile(r"^HloModule\s+([\w.\-]+)")


def device_time_by_scope(trace_dir, hlo_texts, scopes, device_prefix=None):
    """Reduce the newest profiler trace under ``trace_dir`` to device times.

    Parameters
    ----------
    trace_dir : directory given to ``jax.profiler.start_trace``.
    hlo_texts : compiled HLO texts (``compiled.as_text()``) of the traced
        programs, used to map each event to source scopes through its
        module (``hlo_module``) and instruction. On a GPU, kernels that XLA
        groups into a command buffer carry ``hlo_op="command_buffer"``; the
        event's own name (the fusion's) then names the instruction.
    scopes : ``{label: substring}``; an event counts for the first label
        whose substring occurs in one of its op_name paths or in the event's
        name (a Pallas kernel is named after its ``pallas_call``).
    device_prefix : planes to read (default: GPU device planes, else the
        host CPU plane, where XLA:CPU records its kernels).

    Returns a dict with ``busy_s`` (union of device event intervals),
    ``window_s`` (first start to last end), ``idle_share``, ``by_scope``
    (seconds per label, plus ``"other"``) and ``top`` (the ten longest
    (kernel, seconds, label) totals).
    """
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                          "*", "*.xplane.pb")),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = ProfileData.from_file(paths[-1])
    by_module = {}
    for text in hlo_texts:
        m = _MODULE.match(text)
        by_module.setdefault(m.group(1) if m else None, {}).update(
            hlo_op_scopes(text))
    merged = {}
    for sc in by_module.values():
        merged.update(sc)

    planes = list(data.planes)
    if device_prefix is None:
        device_prefix = ("/device:GPU" if any(
            p.name.startswith("/device:GPU") for p in planes) else "/host:CPU")
    by_scope = {label: 0.0 for label in scopes}
    by_scope["other"] = 0.0
    per_op, intervals = {}, []
    for plane in planes:
        if not plane.name.startswith(device_prefix):
            continue
        for line in plane.lines:
            # GPU planes repeat kernels on derived "XLA Ops"/"XLA Modules"
            # lines; the stream lines hold each launch once
            if plane.name.startswith("/device:GPU") and not \
                    line.name.startswith("Stream"):
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                op = stats.get("hlo_op")
                if op is None:
                    continue
                op_scopes = by_module.get(str(stats.get("hlo_module")),
                                          merged)
                name = (ev.name if ev.name in op_scopes
                        or op == "command_buffer" else str(op))
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                paths_ = set(op_scopes.get(name, ())) | {ev.name}
                label = next((lab for lab, sub in scopes.items()
                              if any(sub in p for p in paths_)), "other")
                by_scope[label] += ev.duration_ns * 1e-9
                key = (name, label)
                per_op[key] = per_op.get(key, 0.0) + ev.duration_ns * 1e-9
    if not intervals:
        raise ValueError(f"no device events with hlo_op on {device_prefix}")
    busy = _union_ns(intervals) * 1e-9
    window = (max(b for _, b in intervals)
              - min(a for a, _ in intervals)) * 1e-9
    top = sorted(((op, t, lab) for (op, lab), t in per_op.items()),
                 key=lambda r: -r[1])[:10]
    return {"busy_s": busy, "window_s": window,
            "idle_share": 1.0 - busy / window if window > 0 else 0.0,
            "by_scope": by_scope, "top": top}
