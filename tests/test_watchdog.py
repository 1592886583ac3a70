"""Stall watchdog (utils/watchdog.py): the self-heal for hung device
calls that block jax.device_get forever (SURVEY.md §5 failure
recovery — the reference has none)."""

import subprocess
import sys
import time

from scrabblegan.utils.watchdog import STALL_EXIT_CODE, StallWatchdog


class TestStallWatchdog:
    def test_beats_keep_it_alive_and_stop_works(self):
        wd = StallWatchdog(timeout_s=0.4).start()
        for _ in range(4):
            time.sleep(0.15)
            wd.beat()  # stays under the timeout only thanks to the beats
        wd.stop()
        time.sleep(0.6)  # would have fired by now if stop() didn't take

    def test_stall_exits_process_with_code_86(self):
        # os._exit can't be tested in-process; run the stall in a subprocess
        code = (
            "import time\n"
            "from scrabblegan.utils.watchdog import StallWatchdog\n"
            "StallWatchdog(timeout_s=0.3).start()\n"
            "time.sleep(10)\n"
        )
        proc = subprocess.run([sys.executable, "-c", code], timeout=30,
                              capture_output=True, text=True)
        assert proc.returncode == STALL_EXIT_CODE
        assert "no progress" in proc.stderr

    def test_grace_defers_then_restores_firing(self):
        # in-process firing would os._exit pytest; observe it in a subprocess:
        # timeout 0.3 + grace 1.5 => still alive at t=1.0, fired by t=3.5
        code = (
            "import time\n"
            "from scrabblegan.utils.watchdog import StallWatchdog\n"
            "wd = StallWatchdog(timeout_s=0.3).start()\n"
            "wd.grace(1.5)\n"
            "time.sleep(1.0)\n"
            "print('alive-after-timeout', flush=True)\n"
            "time.sleep(10)\n"
        )
        proc = subprocess.run([sys.executable, "-c", code], timeout=30,
                              capture_output=True, text=True)
        assert "alive-after-timeout" in proc.stdout  # grace held at t=1.0
        assert proc.returncode == STALL_EXIT_CODE    # then fired normally

    def test_beat_supersedes_grace(self):
        wd = StallWatchdog(timeout_s=5.0)
        wd.grace(1000.0)
        wd.beat()
        import time as _t

        assert wd._last_beat <= _t.monotonic()  # tight cadence restored

    def test_touch_file_heartbeat(self, tmp_path):
        hb = tmp_path / ".heartbeat"
        wd = StallWatchdog(timeout_s=1.0, touch_file=str(hb)).start()
        try:
            deadline = time.time() + 5
            while not hb.exists() and time.time() < deadline:
                time.sleep(0.05)
            assert hb.exists()
            m0 = hb.stat().st_mtime_ns
            time.sleep(0.6)  # poll cadence = timeout/4 = 0.25s
            wd.beat()
            assert hb.stat().st_mtime_ns > m0
        finally:
            wd.stop()

    def test_rejects_nonpositive_timeout(self):
        import pytest

        with pytest.raises(ValueError):
            StallWatchdog(timeout_s=0)

    def test_trainer_wires_it(self):
        """config key exists and Trainer.train reads it (smoke via source —
        the full loop is exercised by slow tests)."""
        from scrabblegan.config import IOConfig

        assert IOConfig().stall_timeout_s == 0.0
        import inspect

        from scrabblegan.train import loop

        src = inspect.getsource(loop.Trainer.train)
        assert "stall_timeout_s" in src and "watchdog.beat()" in src
        # cold-compile grace: first dispatch of each new batch shape + first
        # artifact save announce a compile-length progress-free block
        assert "compile_grace_s" in src and "grace_for_new_shape(batch)" in src
        assert ".heartbeat" in src  # outer-supervisor liveness file
        assert IOConfig().compile_grace_s > 0


class TestProbedGrace:
    """VERDICT r4 item 9: during an announced grace window the watchdog fires
    a backend-liveness probe — compile-in-progress (probe answers) holds the
    grace; a dead backend (probe hangs/raises) is caught in ~probe_interval +
    probe_timeout instead of waiting out grace + timeout."""

    def test_hung_probe_fires_fast_inside_grace(self):
        # grace 300s would hold ~300.3s without probing; a hung probe must
        # fire at ~interval(0.2) + probe_timeout(0.4) << grace
        code = (
            "import time\n"
            "from scrabblegan.utils.watchdog import StallWatchdog\n"
            "wd = StallWatchdog(timeout_s=0.4,\n"
            "                   probe=lambda: time.sleep(999)).start()\n"
            "wd.grace(300.0)\n"
            "time.sleep(30)\n"
        )
        t0 = time.time()
        proc = subprocess.run([sys.executable, "-c", code], timeout=30,
                              capture_output=True, text=True)
        assert proc.returncode == STALL_EXIT_CODE
        assert "liveness probe failed" in proc.stderr
        assert time.time() - t0 < 15  # 2x timeout_s + interpreter startup

    def test_raising_probe_counts_as_dead(self):
        code = (
            "import time\n"
            "from scrabblegan.utils.watchdog import StallWatchdog\n"
            "def probe():\n"
            "    raise RuntimeError('device gone')\n"
            "wd = StallWatchdog(timeout_s=0.4, probe=probe).start()\n"
            "wd.grace(300.0)\n"
            "time.sleep(30)\n"
        )
        proc = subprocess.run([sys.executable, "-c", code], timeout=30,
                              capture_output=True, text=True)
        assert proc.returncode == STALL_EXIT_CODE
        assert "treating as backend failure" in proc.stderr

    def test_healthy_probe_holds_grace(self):
        # probes answer -> the long "compile" (sleep) survives the whole
        # grace window; a beat then ends the run cleanly
        code = (
            "import time\n"
            "from scrabblegan.utils.watchdog import StallWatchdog\n"
            "wd = StallWatchdog(timeout_s=0.4, probe=lambda: 1.0).start()\n"
            "wd.grace(2.0)\n"
            "time.sleep(1.8)\n"          # several probe intervals pass
            "wd.beat(); wd.stop()\n"
            "print('compile-survived', flush=True)\n"
        )
        proc = subprocess.run([sys.executable, "-c", code], timeout=30,
                              capture_output=True, text=True)
        assert proc.returncode == 0
        assert "compile-survived" in proc.stdout

    def test_no_probe_keeps_old_semantics(self):
        # without a probe, grace defers firing exactly as before
        wd = StallWatchdog(timeout_s=5.0)
        wd.grace(1000.0)
        assert wd.probe is None

    def test_device_roundtrip_probe_completes(self):
        from scrabblegan.utils.watchdog import device_roundtrip_probe

        assert device_roundtrip_probe()() == 1.0

    def test_trainer_passes_probe(self):
        import inspect

        from scrabblegan.train import loop

        src = inspect.getsource(loop.Trainer.train)
        assert "device_roundtrip_probe" in src
