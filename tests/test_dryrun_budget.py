"""dryrun_multichip budget machinery (__graft_entry__.py, VERDICT r4 item 1):
the fsdp leg always runs; later legs start only when the remaining budget
covers an adaptive estimate scaled from the measured fsdp leg; the checkpoint leg
degrades first; skips print a note instead of dying to an external timeout."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _run(monkeypatch, capsys, budget, leg_secs):
    import __graft_entry__ as g

    calls = []

    def fake_leg(n, mode, ckpt_leg=True):
        calls.append((mode, ckpt_leg))
        time.sleep(leg_secs)

    monkeypatch.setattr(g, "_dryrun_one", fake_leg)
    monkeypatch.setenv("SCRABBLEGAN_DRYRUN_BUDGET_S", str(budget))
    g.dryrun_multichip(8)
    return calls, capsys.readouterr().out


class TestDryrunBudget:
    def test_ample_budget_runs_everything_with_orbax(self, monkeypatch, capsys):
        calls, out = _run(monkeypatch, capsys, budget=60, leg_secs=0.05)
        assert calls == [("fsdp", True), ("tp", True), ("fsdp+tp", True)]
        assert "SKIP" not in out

    def test_tight_budget_skips_later_legs_with_note(self, monkeypatch, capsys):
        # budget ~= one leg: fsdp runs unconditionally, the rest must SKIP
        calls, out = _run(monkeypatch, capsys, budget=0.06, leg_secs=0.05)
        assert [c[0] for c in calls] == ["fsdp"]
        assert out.count("SKIP") == 2
        assert "tests/test_tp.py" in out  # points at the suite coverage

    def test_middle_budget_defers_only_orbax(self, monkeypatch, capsys):
        # enough for ~3.5 legs: all three modes run, checkpoint leg deferred
        calls, out = _run(monkeypatch, capsys, budget=0.20, leg_secs=0.05)
        assert calls == [("fsdp", True), ("tp", True), ("fsdp+tp", False)]
        assert "checkpoint leg deferred" in out

    def test_small_device_count_is_fsdp_only(self, monkeypatch, capsys):
        import __graft_entry__ as g

        calls = []
        monkeypatch.setattr(
            g, "_dryrun_one",
            lambda n, mode, ckpt_leg=True: calls.append(mode))
        g.dryrun_multichip(2)
        assert calls == ["fsdp"]
