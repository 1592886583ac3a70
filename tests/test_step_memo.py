"""make_parallel_train_step process memo (parallel/mesh.py): identical
step-relevant configs yield the SAME jitted callable, so call sites like
bench.py's raw train section and its e2e Trainer share one XLA compilation
in memory, without a persistent-cache lookup."""

from scrabblegan.config import load_config
from scrabblegan.parallel.mesh import make_mesh, make_parallel_train_step
from scrabblegan.train.state import build_models


def _mk(overrides):
    cfg = load_config(None, overrides)
    return cfg, build_models(cfg), make_mesh(1, 1)


class TestStepMemo:
    def test_loop_only_io_knobs_share_one_step(self):
        # bench.py's raw section vs its e2e Trainer: only io.ckpt_every
        # differs — a loop knob the traced step never reads
        cfg1, m1, mesh1 = _mk({"shared.batch_size": 4, "io.seq_len": 5})
        cfg2, m2, mesh2 = _mk({"shared.batch_size": 4, "io.seq_len": 5,
                               "io.ckpt_every": 2})
        s1 = make_parallel_train_step(cfg1, m1, mesh1)
        s2 = make_parallel_train_step(cfg2, m2, mesh2)
        assert s1 is s2

    def test_step_relevant_changes_do_not_share(self):
        cfg1, m1, mesh1 = _mk({"shared.batch_size": 4})
        cfg2, m2, mesh2 = _mk({"shared.batch_size": 4,
                               "optimizer.loss_fn": "not_saturating"})
        assert (make_parallel_train_step(cfg1, m1, mesh1)
                is not make_parallel_train_step(cfg2, m2, mesh2))

    def test_donate_flag_separates(self):
        cfg, m, mesh = _mk({"shared.batch_size": 4})
        assert (make_parallel_train_step(cfg, m, mesh, donate=True)
                is not make_parallel_train_step(cfg, m, mesh, donate=False))
