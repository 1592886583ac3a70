"""Golden-numerics parity fixtures for the loss stack (SURVEY.md §7 "CTC numerics
parity testing against reference values").

The reference computes CTC via tf.keras.backend.ctc_batch_cost
(/root/reference/src/bigacgan/net_architecture.py:57-74) and GAN losses via
net_loss.py:4-54. TensorFlow is not available in this image, so the golden
oracle here is an INDEPENDENT pure-numpy implementation of the same math:

- CTC: the textbook Graves-2006 log-space forward algorithm over the
  blank-extended label sequence with blank = last class — exactly the
  definition ctc_batch_cost implements (its only deviation is a +1e-7 epsilon
  inside log(softmax), below our 1e-4 tolerance).
- hinge / not_saturating: the reference's closed-form expressions
  (net_loss.py:38-54 / :4-35) evaluated in float64 numpy.

Each case additionally asserts against CONSTANTS precomputed once from the
numpy oracle (embedded as literals) so the oracle itself is pinned: if either
the optax path or the in-test DP drifts, the literals catch it.
"""

import numpy as np
import pytest

from scrabblegan.ops.ctc import ctc_loss
from scrabblegan.ops.losses import hinge, not_saturating


# --------------------------------------------------------------------- oracle
def _log_softmax(x):
    x = x - x.max(axis=-1, keepdims=True)
    return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))


def _logsumexp(*vals):
    m = max(vals)
    if m == -np.inf:
        return -np.inf
    return m + np.log(sum(np.exp(v - m) for v in vals))


def ctc_nll_numpy(logits, labels, logit_len, label_len):
    """Per-sample CTC negative log-likelihood, log-space forward DP.

    logits: (T, K) pre-softmax; blank id = K - 1 (Keras convention).
    labels: (L,) dense ids; first `label_len` entries are valid.
    """
    lp = _log_softmax(np.asarray(logits, np.float64))
    blank = lp.shape[1] - 1
    y = list(np.asarray(labels[:label_len], np.int64))
    ext = [blank]
    for c in y:
        ext += [int(c), blank]
    s = len(ext)  # 2U + 1
    t_valid = int(logit_len)

    alpha = np.full((t_valid, s), -np.inf)
    alpha[0, 0] = lp[0, blank]
    if s > 1:
        alpha[0, 1] = lp[0, ext[1]]
    for t in range(1, t_valid):
        for i in range(s):
            terms = [alpha[t - 1, i]]
            if i >= 1:
                terms.append(alpha[t - 1, i - 1])
            if i >= 2 and ext[i] != blank and ext[i] != ext[i - 2]:
                terms.append(alpha[t - 1, i - 2])
            alpha[t, i] = lp[t, ext[i]] + _logsumexp(*terms)
    tail = [alpha[t_valid - 1, s - 1]]
    if s > 1:
        tail.append(alpha[t_valid - 1, s - 2])
    return -_logsumexp(*tail)


# ---------------------------------------------------------------- CTC fixtures
def _case(seed, b, t, k, lens, lab_lens, l_max):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2.0, (b, t, k)).astype(np.float32)
    labels = np.zeros((b, l_max), np.int32)
    for i, ll in enumerate(lab_lens):
        labels[i, :ll] = rng.integers(0, k - 1, size=ll)
    return (logits, labels, np.asarray(lens, np.int32),
            np.asarray(lab_lens, np.int32))


# (seed, B, T, K, logit_lens, label_lens, L_max, golden per-sample NLL)
# Golden constants computed once from ctc_nll_numpy (this file's oracle) and
# frozen — regenerate only if a case definition changes.
CTC_CASES = [
    # tiny distinct-label case
    (_case(0, 2, 5, 4, [5, 5], [2, 1], 2),
     [1.350008481, 4.4556322045]),
    # repeated label forces a blank between (the classic CTC corner)
    ((np.tile(np.log(np.array(
        [[[0.6, 0.2, 0.2], [0.3, 0.5, 0.2], [0.2, 0.2, 0.6],
          [0.5, 0.3, 0.2], [0.4, 0.1, 0.5]]], np.float32)), (1, 1, 1)),
      np.array([[0, 0]], np.int32), np.array([5], np.int32),
      np.array([2], np.int32)),
     [2.0237419265]),
    # frame padding: only the first 7 of 8 frames are valid
    (_case(1, 2, 8, 6, [7, 8], [3, 2], 3),
     [5.4486085258, 12.3253912503]),
    # realistic recognizer shape: T = 4*5-1 = 19, K = 53 (52 chars + blank)
    (_case(2, 2, 19, 53, [19, 19], [5, 5], 5),
     [87.3800938592, 69.812675817]),
]


class TestGoldenCTC:
    @pytest.mark.parametrize("case_idx", range(len(CTC_CASES)))
    def test_optax_matches_numpy_oracle(self, case_idx):
        (logits, labels, lens, lab_lens), _ = CTC_CASES[case_idx]
        got = np.asarray(ctc_loss(logits, labels, lens, lab_lens))
        want = np.array([
            ctc_nll_numpy(logits[i], labels[i], lens[i], lab_lens[i])
            for i in range(len(logits))])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)

    @pytest.mark.parametrize("case_idx", range(len(CTC_CASES)))
    def test_matches_frozen_constants(self, case_idx):
        (logits, labels, lens, lab_lens), golden = CTC_CASES[case_idx]
        got = np.asarray(ctc_loss(logits, labels, lens, lab_lens))
        np.testing.assert_allclose(got, np.asarray(golden), rtol=1e-5, atol=1e-4)


# --------------------------------------------------------------- GAN fixtures
# Fixed logits; golden values are the reference formulas evaluated in f64.
D_REAL = np.array([1.5, -0.3, 0.2], np.float32)
D_FAKE = np.array([-2.0, 0.8, -0.1], np.float32)
S_POS = np.array([0.4, -1.2, 2.5], np.float32)
S_NEG = np.array([-0.6, 0.9, -1.8], np.float32)
S_G = np.array([0.7, -0.5, 1.1], np.float32)


def _sig_ce(logits, target):
    x = np.asarray(logits, np.float64)
    # max(x,0) - x*z + log(1+exp(-|x|)): the stable sigmoid-CE form
    return np.maximum(x, 0) - x * target + np.log1p(np.exp(-np.abs(x)))


class TestGoldenGANLosses:
    def test_hinge(self):
        d, d_r, d_f, g, s, s_p, s_n = hinge(D_REAL, D_FAKE, S_POS, S_NEG, S_G)
        want_d_r = np.maximum(0, 1 - D_REAL.astype(np.float64))
        want_d_f = np.maximum(0, 1 + D_FAKE.astype(np.float64))
        want_g = -(D_FAKE.astype(np.float64) + S_G.astype(np.float64))
        want_s_p = np.maximum(0, 1 - S_POS.astype(np.float64))
        want_s_n = np.maximum(0, 1 + S_NEG.astype(np.float64))
        np.testing.assert_allclose(np.asarray(d), want_d_r + want_d_f, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(d_r), want_d_r, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(d_f), want_d_f, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(g), want_g, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(s), want_s_p + want_s_n, rtol=1e-6)
        # frozen constants (net_loss.py:38-54 algebra on the fixed logits)
        np.testing.assert_allclose(
            np.asarray(g), [1.3, -0.3, -1.0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(d), [0.0, 3.1, 1.7], rtol=0, atol=1e-6)

    def test_not_saturating(self):
        d, d_r, d_f, g, s, s_p, s_n = not_saturating(
            D_REAL, D_FAKE, S_POS, S_NEG, S_G)
        np.testing.assert_allclose(
            np.asarray(d_r), _sig_ce(D_REAL, 1.0), rtol=1e-5)
        np.testing.assert_allclose(
            np.asarray(d_f), _sig_ce(D_FAKE, 0.0), rtol=1e-5)
        np.testing.assert_allclose(
            np.asarray(g), _sig_ce(D_FAKE, 1.0) + _sig_ce(S_G, 1.0), rtol=1e-5)
        np.testing.assert_allclose(
            np.asarray(s), _sig_ce(S_POS, 1.0) + _sig_ce(S_NEG, 0.0), rtol=1e-5)
        # frozen constants
        np.testing.assert_allclose(
            np.asarray(d), [0.328341, 2.025456, 1.242536], rtol=0, atol=1e-4)
        np.testing.assert_allclose(
            np.asarray(g), [2.530114, 1.345178, 1.031732], rtol=0, atol=1e-4)
