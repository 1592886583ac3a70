"""Self-describing checkpoints: config persistence + discovery (VERDICT r2
item 2). A checkpoint's leaf set depends on parallel.shape_mode and
optimizer.g_ema_decay; the Trainer writes config.json next to every artifact
and the entry points auto-load it, so padded/EMA runs restore with no manual
--set. Fast tests — no jit, no model builds."""

import json
import os

from scrabblegan.config import (
    Config,
    apply_overrides,
    config_to_dict,
    discover_config,
    load_config,
    save_config,
)


class TestSaveLoadRoundtrip:
    def test_padded_ema_fields_survive(self, tmp_path):
        cfg = apply_overrides(Config(), {
            "parallel.shape_mode": "padded",
            "optimizer.g_ema_decay": 0.999,
            "shared.batch_size": 4,
            "io.bucket_size": 3,
        })
        path = save_config(cfg, str(tmp_path / "config.json"))
        loaded = load_config(path)
        # dataclass equality covers every leaf (tuples restored from lists)
        assert loaded == cfg

    def test_pre_lean_config_pins_optax_layout(self, tmp_path):
        """ADVICE r3: a persisted config.json written before the adam_impl
        key existed (full optimizer section, no adam_impl) was trained under
        the 'optax' state layout — loading it must NOT adopt today's 'lean'
        default, or restore fails with an optimizer-tree leaf mismatch."""
        cfg = Config()
        data = config_to_dict(cfg)
        del data["optimizer"]["adam_impl"]
        path = tmp_path / "config.json"
        path.write_text(json.dumps(data))
        loaded = load_config(str(path))
        assert loaded.optimizer.adam_impl == "optax"
        # ...but a file that round-trips the modern key keeps it verbatim
        save_config(cfg, str(path))
        assert load_config(str(path)).optimizer.adam_impl == cfg.optimizer.adam_impl
        # and a minimal hand-written config with NO optimizer section gets
        # pure dataclass defaults (it never described a checkpoint layout)
        (tmp_path / "mini.json").write_text(json.dumps({"shared": {"batch_size": 4}}))
        assert (load_config(str(tmp_path / "mini.json")).optimizer.adam_impl
                == Config().optimizer.adam_impl)

    def test_dict_matches_json(self, tmp_path):
        cfg = Config()
        path = save_config(cfg, str(tmp_path / "config.json"))
        with open(path) as f:
            on_disk = json.load(f)
        # JSON has no tuples; compare via a JSON round-trip of the live dict
        assert on_disk == json.loads(json.dumps(config_to_dict(cfg)))


class TestDiscovery:
    def test_walks_up_from_export_depth(self, tmp_path):
        """<workdir>/model/generator/<epoch> must find <workdir>/config.json."""
        workdir = tmp_path / "run"
        export = workdir / "model" / "generator" / "7"
        export.mkdir(parents=True)
        save_config(Config(), str(workdir / "config.json"))
        found = discover_config(str(export))
        assert found == str(workdir / "config.json")

    def test_nearest_wins(self, tmp_path):
        """model/config.json shadows the workdir one (both are written; the
        nearest describes the artifact being loaded)."""
        workdir = tmp_path / "run"
        model = workdir / "model"
        model.mkdir(parents=True)
        save_config(Config(), str(workdir / "config.json"))
        padded = apply_overrides(Config(), {"parallel.shape_mode": "padded"})
        save_config(padded, str(model / "config.json"))
        found = discover_config(str(model))
        assert found == str(model / "config.json")
        assert load_config(found).parallel.shape_mode == "padded"

    def test_none_when_absent(self, tmp_path):
        d = tmp_path / "empty" / "deep"
        d.mkdir(parents=True)
        assert discover_config(str(d), max_up=1) is None

    def test_max_up_zero_is_exact_dir(self, tmp_path):
        save_config(Config(), str(tmp_path / "config.json"))
        sub = tmp_path / "sub"
        sub.mkdir()
        assert discover_config(str(sub), max_up=0) is None
        assert discover_config(str(tmp_path), max_up=0) is not None


class TestDtypeValidation:
    """ADVICE r4: a typo'd compute dtype must raise, not silently run f32."""

    def test_bad_trunk_dtype_rejected(self):
        import pytest

        from scrabblegan.config import apply_overrides
        from scrabblegan.train.state import build_models

        for bad in ("bf16", "float16", "half"):
            cfg = apply_overrides(Config(), {"shared.trunk_dtype": bad})
            with pytest.raises(ValueError, match="trunk_dtype"):
                build_models(cfg)

    def test_bad_dtype_rejected(self):
        import pytest

        from scrabblegan.config import apply_overrides
        from scrabblegan.train.state import build_models

        cfg = apply_overrides(Config(), {"shared.dtype": "fp32"})
        with pytest.raises(ValueError, match="shared.dtype"):
            build_models(cfg)

    def test_good_values_accepted(self):
        from scrabblegan.config import apply_overrides
        from scrabblegan.train.state import build_models

        for good in ("", "float32", "bfloat16"):
            cfg = apply_overrides(Config(), {"shared.trunk_dtype": good})
            build_models(cfg)
