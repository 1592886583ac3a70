"""In-process stall watchdog for long training runs.

A hung device, driver or interconnect can leave the host blocked FOREVER
inside ``jax.device_get`` (a C++ wait with the GIL released, e.g. under
``flush_pending`` or an epoch eval). No Python-level recovery is possible once the wait has started, so the only
safe self-heal is a supervised process exit: an outer supervisor
(``scripts/run_campaign.sh``, or any retry wrapper watching for exit code
``STALL_EXIT_CODE``) restarts the run, which resumes from its last
checkpoint (``io.ckpt_every``).

The reference has no failure-recovery story at all (SURVEY.md §5: a mid-run
crash loses everything); this plus checkpoint resume is the replacement.

Usage:
    wd = StallWatchdog(timeout_s=900)
    wd.start()
    ...
    wd.beat()   # after every unit of observable progress
    ...
    wd.stop()

``timeout_s`` must exceed the slowest LEGITIMATE blocking operation of the
run — or the caller must announce known-long blocks with ``grace(s)`` (a
one-shot window used before the first dispatch of every new batch shape,
where a cold XLA compile can block for minutes) — or the watchdog will
shoot a healthy run.

Grace-window liveness probing (VERDICT r4 item 9): a blanket grace used to
mean a REAL stall landing on a first-of-signature dispatch was only caught
after ``compile_grace_s + timeout_s`` (~45-60 min at the defaults). With a
``probe`` callable configured (Trainer passes a device round trip:
device_put + device_get of one scalar), the watchdog DISCRIMINATES
"compile in progress" from "lost backend" during every grace window: a
healthy backend answers the probe in milliseconds even while XLA compiles,
so the grace holds; a dead backend hangs the probe, and the
watchdog fires after ``probe_timeout_s`` instead of waiting out the grace.
Worst-case detection for a stall during a cold compile drops to
``probe_interval + probe_timeout`` <= 2x ``timeout_s``.

``touch_file`` (optional) is touched on every poll while the watchdog still
considers the process healthy, so a FILE-ACTIVITY supervisor (the outer
``run_campaign.sh`` loop) can keep a tight window without false-killing
compile-bound phases: liveness = the heartbeat mtime, progress = this
watchdog, hard interpreter death = process exit.
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time
from typing import Callable, Optional

STALL_EXIT_CODE = 86


class StallWatchdog:
    def __init__(self, timeout_s: float, label: str = "train",
                 touch_file: str | None = None,
                 probe: Optional[Callable[[], object]] = None,
                 probe_timeout_s: float | None = None):
        if timeout_s <= 0:
            raise ValueError("timeout_s must be positive")
        self.timeout_s = float(timeout_s)
        self.label = label
        self.touch_file = touch_file
        # backend-liveness probe, fired only inside announced grace windows.
        # Must be a SMALL synchronous operation that completes iff the
        # backend's data plane is alive (e.g. a scalar device round trip) —
        # never a compile-triggering call.
        self.probe = probe
        self.probe_timeout_s = float(probe_timeout_s or timeout_s)
        # probe cadence: detection bound = interval + probe_timeout; at
        # interval = timeout/2 the bound stays within 1.5x timeout_s
        self.probe_interval_s = self.timeout_s / 2.0
        self._last_beat = time.monotonic()
        self._grace_until = 0.0
        self._last_probe = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def beat(self) -> None:
        self._last_beat = time.monotonic()
        self._grace_until = 0.0  # progress observed: the long block is over

    def grace(self, seconds: float) -> None:
        """Announce an expected progress-free block (cold compile, multi-GB
        checkpoint fetch): firing is deferred as if a beat were going to
        arrive ``seconds`` from now, i.e. the next possible fire time is
        ``now + seconds + timeout_s``. A real beat afterwards returns to
        normal cadence. While the window is open, a configured ``probe``
        keeps checking the backend is actually alive (see module docstring)."""
        now = time.monotonic()
        self._last_beat = max(self._last_beat, now + float(seconds))
        self._grace_until = max(self._grace_until, now + float(seconds))
        self._last_probe = now  # first probe one interval into the window

    def _touch(self) -> None:
        if not self.touch_file:
            return
        try:
            with open(self.touch_file, "a"):
                pass
            os.utime(self.touch_file, None)
        except OSError:
            pass

    def start(self) -> "StallWatchdog":
        self.beat()
        self._thread = threading.Thread(
            target=self._run, name=f"stall-watchdog-{self.label}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _fire(self, why: str, idle: float) -> None:
        sys.stderr.write(
            f"\n[watchdog:{self.label}] {why} ({idle:.0f}s): assuming a hung "
            f"device call; dumping stacks and exiting "
            f"{STALL_EXIT_CODE} for supervised retry\n")
        sys.stderr.flush()
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        sys.stderr.flush()
        os._exit(STALL_EXIT_CODE)

    def _probe_once(self) -> bool:
        """Run the probe on a throwaway thread; True iff it completed within
        probe_timeout_s. A hung probe leaks one daemon thread — irrelevant,
        because a failed probe fires the watchdog anyway."""
        done = threading.Event()
        err: list = []

        def _p():
            try:
                self.probe()
            except Exception as e:  # noqa: BLE001 — a raising probe is a dead backend
                err.append(e)
            done.set()

        threading.Thread(target=_p, daemon=True,
                         name=f"watchdog-probe-{self.label}").start()
        ok = done.wait(self.probe_timeout_s)
        if ok and err:
            sys.stderr.write(f"[watchdog:{self.label}] liveness probe raised "
                             f"{err[0]!r} — treating as backend failure\n")
            return False
        return ok

    def _run(self) -> None:
        poll = max(0.05, min(5.0, self.timeout_s / 4))
        self._touch()
        while not self._stop.wait(poll):
            now = time.monotonic()
            if (self.probe is not None and now < self._grace_until
                    and now - self._last_probe >= self.probe_interval_s):
                self._last_probe = now
                if not self._probe_once():
                    self._fire("backend liveness probe failed during "
                               "announced grace window",
                               time.monotonic() - self._last_probe)
                if self._stop.is_set():
                    break
            idle = time.monotonic() - self._last_beat
            if idle <= self.timeout_s:
                # touch only on healthy polls, so the heartbeat mtime
                # post-mortems as "last time the watchdog saw progress"
                self._touch()
            else:
                self._fire(f"no progress for {idle:.0f}s "
                           f"(> {self.timeout_s:.0f}s)", idle)


def device_roundtrip_probe() -> Callable[[], object]:
    """The Trainer's backend-liveness probe: one scalar H2D + D2H round trip
    on the default device. No compilation involved, so it completes in
    milliseconds on a healthy backend even while XLA compiles — and hangs
    exactly when a hung device would hang the training loop's own
    device_get."""
    import jax
    import numpy as np

    def probe():
        x = jax.device_put(np.float32(1.0))
        return float(jax.device_get(x))

    return probe
