"""Statistical CPU profiler + flamegraph rendering (stdlib only).

Role of the reference's on-demand pprof endpoint
(`quickwit-serve/src/developer_api/pprof.rs:167`, pprof-rs flamegraphs):
a sampling thread snapshots every Python thread's stack via
`sys._current_frames()` at a fixed rate for a bounded duration, then the
samples render either as collapsed stacks (Brendan Gregg format — one
`frame;frame;frame count` line per unique stack, feedable to any
flamegraph toolchain) or as a self-contained SVG flamegraph.

Sampling is cooperative and safe: `_current_frames` is a consistent
point-in-time snapshot taken under the GIL, there is no signal handling,
and the profiler thread pays the only overhead (~hz stack walks/sec)."""

from __future__ import annotations

import html
import sys
import threading
from collections import Counter
from typing import Optional

from ..common.clock import monotonic, sleep


# serializes on-demand profiles (the REST endpoint takes it non-blocking)
# qwlint: disable-next-line=QW008 - metrics/tracing leaf locks; counter updates
# only, no instrumented ops inside
PROFILE_LOCK = threading.Lock()


def _frame_label(frame) -> str:
    code = frame.f_code
    filename = code.co_filename
    # trim to the package-relative tail: keeps labels readable
    for marker in ("/quickwit_tpu_torch/", "/tests/"):
        idx = filename.rfind(marker)
        if idx >= 0:
            filename = filename[idx + 1:]
            break
    else:
        filename = filename.rsplit("/", 1)[-1]
    return f"{code.co_name} ({filename}:{frame.f_lineno})"


def sample_stacks(duration_secs: float = 2.0, hz: float = 100.0,
                  exclude_thread_ids: Optional[set[int]] = None
                  ) -> Counter:
    """Counter of stack tuples (root→leaf) across all threads."""
    interval = 1.0 / max(hz, 1.0)
    # clock seam: under the DST harness the sampling window runs on
    # virtual time (a FakeClock sleep advances it), so a profile taken
    # inside a simulated run neither stalls the scheduler nor burns wall
    # clock; in production the seam is the real clock
    deadline = monotonic() + max(duration_secs, 0.0)
    skip = set(exclude_thread_ids or ())
    skip.add(threading.get_ident())  # never profile the profiler
    counts: Counter = Counter()
    while monotonic() < deadline:
        for thread_id, frame in sys._current_frames().items():
            if thread_id in skip:
                continue
            stack = []
            while frame is not None:
                stack.append(_frame_label(frame))
                frame = frame.f_back
            if stack:
                counts[tuple(reversed(stack))] += 1
        sleep(interval)
    return counts


def collapse(counts: Counter) -> str:
    """Brendan Gregg collapsed-stack format (semicolon-joined frames)."""
    lines = [f"{';'.join(stack)} {count}"
             for stack, count in sorted(counts.items())]
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# SVG flamegraph

_ROW_H = 16
_MIN_W = 0.1          # % width below which frames are elided
_PALETTE = ("#e06c2b", "#e28743", "#d9903f", "#cc7a2e", "#e8a05c",
            "#d67f35", "#e0893a", "#ca6f28")


class _Node:
    __slots__ = ("name", "value", "children")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self.children: dict[str, _Node] = {}


def _build_tree(counts: Counter) -> _Node:
    root = _Node("all")
    for stack, count in counts.items():
        root.value += count
        node = root
        for frame in stack:
            child = node.children.get(frame)
            if child is None:
                child = node.children[frame] = _Node(frame)
            child.value += count
            node = child
    return root


def render_svg(counts: Counter, title: str = "quickwit-tpu flamegraph",
               width: int = 1200) -> str:
    """Self-contained SVG flamegraph (no scripts; <title> tooltips)."""
    root = _build_tree(counts)
    total = max(root.value, 1)
    rects: list[str] = []
    max_depth = [0]

    def emit(node: _Node, depth: int, x_pct: float) -> None:
        child_x = x_pct
        for name in sorted(node.children):
            child = node.children[name]
            w_pct = child.value * 100.0 / total
            if w_pct >= _MIN_W:
                max_depth[0] = max(max_depth[0], depth + 1)
                color = _PALETTE[hash(name) % len(_PALETTE)]
                label = (name if w_pct > 8 else "")
                pct = child.value * 100.0 / total
                rects.append(
                    f'<g><title>{html.escape(name)} '
                    f'({child.value} samples, {pct:.1f}%)</title>'
                    f'<rect x="{child_x:.3f}%" y="{depth * _ROW_H}" '
                    f'width="{w_pct:.3f}%" height="{_ROW_H - 1}" '
                    f'fill="{color}" rx="1"/>'
                    + (f'<text x="{child_x + 0.2:.3f}%" '
                       f'y="{depth * _ROW_H + 11}" font-size="10" '
                       f'font-family="monospace">'
                       f'{html.escape(label[:120])}</text>'
                       if label else "")
                    + "</g>")
                emit(child, depth + 1, child_x)
            child_x += w_pct

    emit(root, 1, 0.0)
    height = (max_depth[0] + 2) * _ROW_H + 24
    header = (f'<text x="8" y="14" font-size="12" '
              f'font-family="sans-serif">{html.escape(title)} — '
              f'{total} samples</text>')
    body = "\n".join(rects)
    return (f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
            f'height="{height}" viewBox="0 0 {width} {height}">'
            f'<rect width="100%" height="100%" fill="#fdf6ee"/>'
            f'{header}\n{body}</svg>')
