"""Serving-export tests: StableHLO bundle roundtrip matches direct apply."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scrabblegan.models import Generator
from scrabblegan.train.export import export_generator, load_exported_generator

B, LEN = 2, 3


class TestExport:
    def test_roundtrip_matches_apply(self, tmp_path):
        g = Generator(vocab_size=52, z_source="noise", use_sn=False)
        labels = jnp.zeros((B, LEN), jnp.int32)
        z = jax.random.normal(jax.random.PRNGKey(0), (B, 128))
        variables = g.init(jax.random.PRNGKey(1), labels, z=z, train=False)

        bundle = export_generator(str(tmp_path / "bundle"), g, variables,
                                  batch_size=B, length=LEN, z_source="noise")
        call, meta = load_exported_generator(bundle)
        assert meta["z_source"] == "noise" and meta["length"] == LEN

        test_labels = jnp.asarray(np.random.default_rng(0).integers(
            0, 52, (B, LEN)), jnp.int32)
        out_exported = np.asarray(call(test_labels, z))
        out_direct = np.asarray(g.apply(variables, test_labels, z=z, train=False))
        assert out_exported.shape == (B, 32, 16 * LEN, 1)
        np.testing.assert_allclose(out_exported, out_direct, rtol=1e-5, atol=1e-5)

    def test_bundle_is_self_contained(self, tmp_path):
        """The bundle must load via jax.export alone (no model classes)."""
        g = Generator(vocab_size=52, z_source="noise", use_sn=False)
        labels = jnp.zeros((B, LEN), jnp.int32)
        z = jnp.zeros((B, 128))
        variables = g.init(jax.random.PRNGKey(1), labels, z=z, train=False)
        bundle = export_generator(str(tmp_path / "b2"), g, variables,
                                  batch_size=B, length=LEN, z_source="noise")
        from jax import export as jexport

        with open(f"{bundle}/generator.stablehlo", "rb") as f:
            exported = jexport.deserialize(f.read())
        out = exported.call(labels, z)
        assert out.shape == (B, 32, 16 * LEN, 1)
