"""Unit tests for the pure ops (SURVEY.md §4 test plan: hand-value tests for losses,
balance algebra, CTC conventions, filter bank, blocks, spectral norm state)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scrabblegan.ops import (
    ConditionalBatchNorm,
    FilterBank,
    NonLocalBlock,
    ResNetBlockDown,
    ResNetBlockUp,
    ctc_loss,
    get_loss_fn,
    gradient_balance,
    hinge,
    not_saturating,
)


class TestLosses:
    def test_hinge_hand_values(self):
        d_real = jnp.array([2.0, 0.5])
        d_fake = jnp.array([-2.0, 0.5])
        s_pos = jnp.array([1.0, -1.0])
        s_neg = jnp.array([0.0, 0.0])
        s_g = jnp.array([3.0, -3.0])
        d, dr, df, g, s, sp, sn = hinge(d_real, d_fake, s_pos, s_neg, s_g)
        np.testing.assert_allclose(dr, [0.0, 0.5])
        np.testing.assert_allclose(df, [0.0, 1.5])
        np.testing.assert_allclose(d, [0.0, 2.0])
        np.testing.assert_allclose(sp, [0.0, 2.0])
        np.testing.assert_allclose(sn, [1.0, 1.0])
        np.testing.assert_allclose(g, [-1.0, 2.5])  # -(d_fake + s_for_g)

    def test_not_saturating_matches_sigmoid_ce(self):
        x = jnp.array([0.3, -1.2])
        d, dr, df, g, s, sp, sn = not_saturating(x, x, x, x, x)
        # sce(x, 1) = softplus(-x); sce(x, 0) = softplus(x)
        np.testing.assert_allclose(dr, jnp.logaddexp(0.0, -x), rtol=1e-6)
        np.testing.assert_allclose(df, jnp.logaddexp(0.0, x), rtol=1e-6)
        np.testing.assert_allclose(g, 2 * jnp.logaddexp(0.0, -x), rtol=1e-6)

    def test_registry(self):
        assert get_loss_fn("hinge") is hinge
        assert get_loss_fn("not_saturating") is not_saturating
        with pytest.raises(ValueError):
            get_loss_fn("nope")


class TestBalance:
    def test_algebra(self):
        r = jnp.array([1.0, 3.0])  # std 1.0
        g = jnp.array([0.0, 4.0])  # std 2.0
        gb, rb, alpha, r_std, g_std = gradient_balance(r, g, alpha=1.0)
        np.testing.assert_allclose(r_std, 1.0)
        np.testing.assert_allclose(g_std, 2.0)
        np.testing.assert_allclose(rb, [2.0, 6.0])
        np.testing.assert_allclose(gb, [2.0, 10.0])

    def test_image_gradient_balance(self):
        from scrabblegan.ops.balance import balance_image_gradients

        adv = jnp.array([0.0, 4.0])   # std 2
        ctc = jnp.array([1.0, 3.0])   # std 1
        combined, scale = balance_image_gradients(adv, ctc, alpha=0.5)
        np.testing.assert_allclose(scale, 1.0, rtol=1e-6)
        np.testing.assert_allclose(combined, [1.0, 7.0], rtol=1e-6)

    def test_balanced_fanout_backward(self):
        """The fanout is identity forward; backward combines the two branch
        cotangents as adv + alpha*(std(adv)/std(ctc))*ctc."""
        from scrabblegan.ops.balance import balanced_fanout

        x = jnp.arange(6, dtype=jnp.float32).reshape(2, 3)
        c_adv = jnp.array([[1.0, 0.0, 2.0], [0.0, 1.0, 3.0]])
        c_ctc = jnp.array([[0.5, 0.5, 0.5], [2.0, 0.0, 1.0]])

        def f(x):
            a, c = balanced_fanout(x, 1.0)
            return jnp.sum(a * c_adv) + jnp.sum(c * c_ctc)

        ya, yc = balanced_fanout(x, 1.0)
        np.testing.assert_array_equal(np.asarray(ya), np.asarray(x))
        np.testing.assert_array_equal(np.asarray(yc), np.asarray(x))
        got = jax.grad(f)(x)
        scale = float(jnp.std(c_adv) / (jnp.std(c_ctc) + 1e-12))
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(c_adv + scale * c_ctc), rtol=1e-6)


class TestCTC:
    def test_perfect_prediction_low_loss(self):
        # 3 classes (blank = 2), T=5, label [0, 1]
        logits = jnp.full((1, 5, 3), -20.0)
        # frames: 0, blank, 1, blank, blank
        frame_classes = [0, 2, 1, 2, 2]
        logits = logits.at[0, jnp.arange(5), jnp.array(frame_classes)].set(20.0)
        labels = jnp.array([[0, 1]])
        loss = ctc_loss(logits, labels, jnp.array([5]), jnp.array([2]))
        assert loss.shape == (1,)
        assert float(loss[0]) < 1e-3

    def test_logit_length_masks_frames(self):
        key = jax.random.PRNGKey(0)
        logits = jax.random.normal(key, (2, 8, 5))
        labels = jnp.array([[1, 2], [3, 0]])
        full = ctc_loss(logits, labels, jnp.array([8, 8]), jnp.array([2, 2]))
        short = ctc_loss(logits, labels, jnp.array([6, 6]), jnp.array([2, 2]))
        trunc = ctc_loss(logits[:, :6], labels, jnp.array([6, 6]), jnp.array([2, 2]))
        assert not np.allclose(full, short)
        np.testing.assert_allclose(short, trunc, rtol=1e-5)

    def test_blank_is_last_class(self):
        # A label equal to K-1 would collide with the blank — assert convention
        logits = jnp.zeros((1, 4, 3))
        labels = jnp.array([[0]])
        loss = ctc_loss(logits, labels, jnp.array([4]), jnp.array([1]))
        assert jnp.isfinite(loss).all()


class TestFilterBank:
    def test_lookup_shape_and_gather(self, rng):
        fb = FilterBank(vocab_size=5, filter_dim=(4, 8))
        ids = jnp.array([[0, 2], [4, 4]])
        params = fb.init(rng, ids)
        out = fb.apply(params, ids)
        assert out.shape == (2, 2, 4, 8)
        bank = params["params"]["filter_bank"]
        np.testing.assert_allclose(out[0, 1], bank[2])
        np.testing.assert_allclose(out[1, 0], bank[4])

    def test_contract_matches_gather_einsum(self, rng):
        """The fused one-hot matmul form must equal gather + einsum (the TF
        reference semantics, net_architecture.py:267-268)."""
        fb = FilterBank(vocab_size=7, filter_dim=(4, 8))
        ids = jnp.array([[0, 2, 6], [4, 4, 1]])
        z0 = jax.random.normal(rng, (2, 4))
        params = fb.init(rng, ids)
        se = fb.apply(params, ids)  # (B, L, k, d)
        ref = jnp.einsum("bk,blkd->bld", z0, se,
                         preferred_element_type=jnp.float32)
        out = fb.apply(params, ids, z0, method="contract")
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


class TestBlocks:
    def test_up_block_shapes(self, rng):
        x = jnp.ones((2, 4, 12, 512))
        cond = jnp.ones((2, 32))
        blk = ResNetBlockUp(256, is_last_block=False, use_sn=True)
        v = blk.init(rng, x, cond, True)
        y, _ = blk.apply(v, x, cond, True, mutable=["batch_stats"])
        assert y.shape == (2, 8, 24, 256)

    def test_up_block_last_stride(self, rng):
        x = jnp.ones((2, 16, 48, 128))
        cond = jnp.ones((2, 32))
        blk = ResNetBlockUp(64, is_last_block=True, use_sn=False)
        v = blk.init(rng, x, cond, True)
        y, _ = blk.apply(v, x, cond, True, mutable=["batch_stats"])
        assert y.shape == (2, 32, 48, 64)  # width stride 1 on last block

    def test_down_block_shapes(self, rng):
        x = jnp.ones((2, 32, 80, 1))
        blk = ResNetBlockDown(64, is_last_block=False, use_sn=True)
        v = blk.init(rng, x, True)
        y, _ = blk.apply(v, x, True, mutable=["batch_stats"])
        assert y.shape == (2, 16, 40, 64)

    def test_down_block_last_no_pool(self, rng):
        x = jnp.ones((2, 4, 10, 1024))
        blk = ResNetBlockDown(1024, is_last_block=True, use_sn=False)
        v = blk.init(rng, x, True)
        y = blk.apply(v, x, True)
        assert y.shape == (2, 4, 10, 1024)

    def test_cbn_conditioning(self, rng):
        x = jax.random.normal(rng, (4, 8, 8, 16))
        cbn = ConditionalBatchNorm(use_sn=False)
        cond1 = jnp.ones((4, 32))
        cond2 = 2.0 * jnp.ones((4, 32))
        v = cbn.init(rng, x, cond1, True)
        y1, _ = cbn.apply(v, x, cond1, True, mutable=["batch_stats"])
        y2, _ = cbn.apply(v, x, cond2, True, mutable=["batch_stats"])
        # gamma/beta scale linearly with cond (bias-free Dense) -> outputs differ
        assert not np.allclose(y1, y2)
        np.testing.assert_allclose(y2, 2.0 * y1, rtol=1e-4, atol=1e-5)


class TestAttention:
    def test_residual_at_init(self, rng):
        # sigma initialized to 0 -> block is identity at init (arch_ops.py:23-26,67)
        x = jax.random.normal(rng, (2, 8, 16, 64))
        blk = NonLocalBlock(use_sn=False)
        v = blk.init(rng, x, True)
        y = blk.apply(v, x, True)
        np.testing.assert_allclose(y, x, rtol=1e-6)

    def test_output_shape(self, rng):
        x = jax.random.normal(rng, (2, 16, 40, 64))
        blk = NonLocalBlock(use_sn=True)
        v = blk.init(rng, x, True)
        y, _ = blk.apply(v, x, True, mutable=["batch_stats"])
        assert y.shape == x.shape

    @pytest.mark.parametrize("dataflow", ["nhwc", "nhwc1"])
    def test_packed_path_matches_nhwc(self, rng, dataflow):
        """Every use_pallas dataflow — 'nhwc' (three 1x1 convs) and 'nhwc1'
        (one projection matmul on identity-extracted SN kernels) — must share
        the pure-XLA path's param tree and compute the same function AND
        gradients."""
        x = jax.random.normal(rng, (2, 8, 16, 64))
        ref_blk = NonLocalBlock(use_sn=True, use_pallas=False)
        pkd_blk = NonLocalBlock(use_sn=True, use_pallas=True, dataflow=dataflow)
        v_ref = ref_blk.init(rng, x, True)
        v_pkd = pkd_blk.init(rng, x, True)
        jax.tree.map(np.testing.assert_array_equal, v_ref, v_pkd)

        # sigma=0 at init makes the block identity; enable the attention path
        v = jax.tree.map(lambda a: a, v_ref)
        v["params"]["sigma"] = jnp.asarray(0.7)

        y_ref, s_ref = ref_blk.apply(v, x, True, mutable=["batch_stats"])
        y_pkd, s_pkd = pkd_blk.apply(v, x, True, mutable=["batch_stats"])
        np.testing.assert_allclose(np.asarray(y_pkd), np.asarray(y_ref),
                                   rtol=1e-5, atol=1e-5)
        jax.tree.map(
            lambda a, b: np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6),
            s_ref, s_pkd)

        def loss(blk):
            def f(params, x):
                y, _ = blk.apply({"params": params,
                                  "batch_stats": v["batch_stats"]},
                                 x, True, mutable=["batch_stats"])
                return jnp.sum(jnp.sin(y))
            return f

        g_ref = jax.grad(loss(ref_blk), argnums=(0, 1))(v["params"], x)
        g_pkd = jax.grad(loss(pkd_blk), argnums=(0, 1))(v["params"], x)
        jax.tree.map(
            lambda a, b: np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=2e-4, atol=2e-5),
            g_ref, g_pkd)


class TestSpectralNorm:
    def test_persistent_u_updates_in_train_only(self, rng):
        from scrabblegan.ops.layers import SNDense

        layer = SNDense(8, use_sn=True)
        x = jnp.ones((2, 16))
        v = layer.init(rng, x, True)
        assert "batch_stats" in v  # persistent power-iteration state (fixes defect #3)
        _, upd = layer.apply(v, x, True, mutable=["batch_stats"])
        changed = jax.tree_util.tree_leaves(
            jax.tree.map(lambda a, b: bool((a != b).any()), v["batch_stats"], upd["batch_stats"])
        )
        assert any(changed)
        _, upd_eval = layer.apply(v, x, False, mutable=["batch_stats"])
        unchanged = jax.tree_util.tree_leaves(
            jax.tree.map(
                lambda a, b: bool((a == b).all()), v["batch_stats"], upd_eval["batch_stats"]
            )
        )
        assert all(unchanged)


class TestSubpixelConvTranspose:
    """The 'subpixel' lowering must be the same function as nn.ConvTranspose
    (SAME padding) for every (stride, kernel) shape the generator uses."""

    CASES = [((2, 2), (3, 3)), ((2, 2), (1, 1)), ((2, 1), (3, 3)), ((2, 1), (1, 1))]

    @pytest.mark.parametrize("strides,ksize", CASES)
    def test_matches_dilated_lowering(self, rng, strides, ksize):
        from scrabblegan.ops.layers import SNConvTranspose

        x = jax.random.normal(rng, (2, 4, 6, 16))
        ref = SNConvTranspose(8, ksize, strides=strides, use_sn=False, lowering="dilated")
        sub = SNConvTranspose(8, ksize, strides=strides, use_sn=False, lowering="subpixel")
        v = ref.init(rng, x, True)
        y_ref = ref.apply(v, x, True)
        y_sub = sub.apply(v, x, True)  # identical param tree by construction
        assert y_sub.shape == (2, 4 * strides[0], 6 * strides[1], 8)
        np.testing.assert_allclose(y_sub, y_ref, atol=2e-5, rtol=1e-5)

    def test_gradients_match(self, rng):
        from scrabblegan.ops.layers import SNConvTranspose

        x = jax.random.normal(rng, (2, 4, 6, 16))
        v = SNConvTranspose(8, (3, 3), strides=(2, 2), use_sn=False,
                            lowering="dilated").init(rng, x, True)

        def loss(variables, x, lowering):
            layer = SNConvTranspose(8, (3, 3), strides=(2, 2), use_sn=False,
                                    lowering=lowering)
            y = layer.apply(variables, x, True)
            return jnp.sum(y * y)

        g_ref = jax.grad(loss, argnums=(0, 1))(v, x, "dilated")
        g_sub = jax.grad(loss, argnums=(0, 1))(v, x, "subpixel")
        jax.tree.map(
            lambda a, b: np.testing.assert_allclose(a, b, atol=5e-5, rtol=1e-4),
            g_ref, g_sub,
        )

    def test_spectral_norm_state_shared(self, rng):
        from scrabblegan.ops.layers import SNConvTranspose

        x = jax.random.normal(rng, (2, 4, 6, 16))
        v_ref = SNConvTranspose(8, (3, 3), use_sn=True, lowering="dilated").init(rng, x, True)
        v_sub = SNConvTranspose(8, (3, 3), use_sn=True, lowering="subpixel").init(rng, x, True)
        ref_paths = {jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(v_ref)}
        sub_paths = {jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(v_sub)}
        assert ref_paths == sub_paths  # checkpoints interchangeable
