"""The bare CLI must train in the quality-recommended regime, not the
measured-unstable bucketed default (VERDICT r4 item 4): `python train.py`
without --config resolves configs/recommended.json; `--config none` opts back
into the reference-exact library defaults; multi-epoch bucketed runs get a
loud warning. Evidence: docs/QUALITY.md rounds 3-4 (every bucketed
quality-campaign arm collapses; padded controls train stably)."""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scrabblegan.config import Config, ParallelConfig, load_config


class TestDefaultConfig:
    def test_resolves_recommended(self):
        import train as train_cli

        path = train_cli.resolve_default_config()
        assert path is not None and path.endswith(
            os.path.join("configs", "recommended.json"))
        cfg = load_config(path)
        assert cfg.parallel.shape_mode == "padded"
        assert cfg.optimizer.g_ema_decay > 0
        assert cfg.shared.trunk_dtype == "bfloat16"
        # explicit in the file — the missing-key back-compat shim must NOT
        # downgrade the recommended regime to the optax state layout
        assert cfg.optimizer.adam_impl == "lean"

    def test_library_default_stays_reference_exact(self):
        # the LIBRARY default keeps reference shape semantics; only the CLI
        # layers the recommended regime on top
        assert Config().parallel.shape_mode == "bucketed"

    def test_config_none_sentinel(self):
        # parse + resolution logic: '--config none' means dataclass defaults
        import train as train_cli

        args = train_cli.parse_args(["--config", "none"])
        assert args.config == "none"
        args = train_cli.parse_args([])
        assert args.config is None


class TestBucketedWarning:
    def _cfg(self, mode):
        return dataclasses.replace(
            Config(), parallel=ParallelConfig(shape_mode=mode))

    def test_warns_on_multiepoch_bucketed(self):
        from scrabblegan.train.loop import bucketed_regime_warning

        msg = bucketed_regime_warning(self._cfg("bucketed"), epochs=10)
        assert msg and "QUALITY.md" in msg and "padded" in msg

    def test_silent_when_safe(self):
        from scrabblegan.train.loop import bucketed_regime_warning

        assert bucketed_regime_warning(self._cfg("bucketed"), epochs=1) is None
        assert bucketed_regime_warning(self._cfg("padded"), epochs=10) is None


class TestInferJitted:
    def test_cli_path_is_jitted(self):
        """VERDICT r4 weak #5: infer.py must run the generator through ONE
        jitted dispatch, not op-by-op apply."""
        import infer
        from scrabblegan.train.state import build_models

        generator = build_models(Config()).generator
        fn = infer.make_apply(generator)
        # a jit-wrapped callable exposes the staging API; a bare bound
        # method does not
        assert hasattr(fn, "lower") and hasattr(fn, "trace")
        assert not hasattr(generator.apply, "lower")
