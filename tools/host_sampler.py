"""Where a Python script's host time goes: run it under a sampling thread.

    python tools/host_sampler.py --out build/host_samples.txt \\
        -- chip_smoke.py --phases 3,7

The script runs in this process (``runpy``, with its own ``sys.argv``);
every ``--interval`` seconds a thread reads the main thread's Python
stack.  Each sample weighs the seconds since the one before it, so the
report is in seconds: inclusive by function (a function on the stack,
however deep), self by the innermost frame, and the stacks of the
script's own file alone.  The thread holds the interpreter lock for the
read only (tens of microseconds a sample at the default interval of
10 ms).  A frame's function is ``file:function``, the file relative to
the current directory or to its site-packages.
"""

from __future__ import annotations

import argparse
import collections
import os
import runpy
import sys
import threading
import time


def _where(code) -> str:
    path = code.co_filename
    if "site-packages" in path:
        path = path.split("site-packages" + os.sep, 1)[1]
    else:
        path = os.path.relpath(path)
    return f"{path}:{code.co_name}"


class Sampler(threading.Thread):
    def __init__(self, interval: float, script: str):
        super().__init__(daemon=True)
        self.interval, self.script = interval, os.path.abspath(script)
        self.target = threading.main_thread().ident
        self.samples, self.last = 0, time.perf_counter()
        self.inclusive = collections.Counter()
        self.innermost = collections.Counter()
        self.own_stacks = collections.Counter()
        self.done = threading.Event()

    def run(self):
        while not self.done.wait(self.interval):
            frame = sys._current_frames().get(self.target)
            if frame is None:
                continue
            names, own = [], []
            while frame is not None:
                code = frame.f_code
                names.append(_where(code))
                if os.path.abspath(code.co_filename) == self.script:
                    own.append(code.co_name)
                frame = frame.f_back
            now = time.perf_counter()
            dt, self.last = now - self.last, now
            self.samples += 1
            self.innermost[names[0]] += dt
            for name in set(names):
                self.inclusive[name] += dt
            self.own_stacks[";".join(reversed(own))] += dt


def report(sampler: Sampler, wall: float, top: int) -> str:
    lines = [f"{sampler.samples} samples, one every "
             f"{sampler.interval * 1e3:.1f} ms or more, over {wall:.1f} s of "
             "wall time; seconds", ""]
    for title, counter in (
            ("inclusive, by function", sampler.inclusive),
            ("self, by the innermost frame", sampler.innermost),
            ("the script's own stacks", sampler.own_stacks)):
        lines.append(f"== {title} ==")
        lines += [f"{secs:9.2f}  {key}"
                  for key, secs in counter.most_common(top)]
        lines.append("")
    return "\n".join(lines)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="the report's path")
    ap.add_argument("--interval", type=float, default=0.01,
                    help="seconds between samples")
    ap.add_argument("--top", type=int, default=400,
                    help="lines of each table")
    ap.add_argument("script", help="the script, then its arguments "
                                   "(after --)")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    sampler = Sampler(args.interval, args.script)
    sys.argv = [args.script, *args.args]
    sys.path.insert(0, os.path.dirname(os.path.abspath(args.script)))
    t0 = time.perf_counter()
    sampler.start()
    code = 0
    try:
        runpy.run_path(args.script, run_name="__main__")
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None
                                                       else 1)
    finally:
        sampler.done.set()
        sampler.join()
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(report(sampler, time.perf_counter() - t0, args.top))
    return code


if __name__ == "__main__":
    sys.exit(main())
