"""Reference fake-bucket semantics at bounded compile cost (VERDICT r2 item 4).

The reference draws the FAKE batch's word-length bucket uniformly at random
each step, independent of the real batch's population-weighted bucket
(/root/reference/src/bigacgan/data_utils.py:385-387). In bucketed shape mode
that costs up to bucket_size^2 (real, fake) XLA specializations; in PADDED
shape mode every batch shares ONE static shape and the true lengths ride as
data (per-sample masks + CTC lengths), so `parallel.shape_mode='padded'` +
`bucket_pairing='independent'` IS the reference's semantics at exactly one
compilation. These tests pin that equivalence distribution-by-distribution
on the host assembly path (no jit — the step's handling of padded lengths is
covered by tests/test_padded.py)."""

import dataclasses

import numpy as np
import pytest

from scrabblegan.config import Config, IOConfig, ParallelConfig, SharedSpecs
from scrabblegan.data.synthetic import make_synthetic_dataset

B = 16
L_MAX = 5


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pairing_data"))
    # deliberately skewed populations so "population-weighted" is detectable
    return make_synthetic_dataset(root, samples_per_bucket=6,
                                  bucket_size=L_MAX)


def _trainer(data, tmp_path_factory, **parallel_kw):
    from scrabblegan.train.loop import Trainer

    read_dir, words_file, style_dir = data
    cfg = Config(
        shared=dataclasses.replace(SharedSpecs(), batch_size=B),
        io=dataclasses.replace(IOConfig(), bucket_size=L_MAX),
        parallel=ParallelConfig(num_devices=1, shape_mode="padded",
                                **parallel_kw),
    )
    t = Trainer(cfg, workdir=str(tmp_path_factory.mktemp("wd")), verbose=False)
    t.load_data(read_dir=read_dir, style_dir=style_dir, words_file=words_file)
    return t

class TestIndependentPairingPadded:
    N_BATCHES = 400

    @pytest.fixture(scope="class")
    def batches(self, data, tmp_path_factory):
        t = _trainer(data, tmp_path_factory, bucket_pairing="independent")
        return t, [t._assemble() for _ in range(self.N_BATCHES)]

    def test_single_static_shape(self, batches):
        """One (shape, dtype) signature across every step = ONE compilation —
        the compile count is 1 <= bucket_size, closing the bucketed path's
        lazy up-to-bucket_size^2 specialization problem."""
        _, bs = batches
        sigs = {tuple((k, v.shape, str(v.dtype)) for k, v in sorted(b.items()))
                for b in bs}
        assert len(sigs) == 1

    def test_fake_bucket_uniform(self, batches):
        """data_utils.py:386: fake bucket ~ Uniform{1..bucket_size}."""
        _, bs = batches
        fakes = np.array([b["fake_lengths"][0] for b in bs])
        counts = np.bincount(fakes, minlength=L_MAX + 1)[1:]
        assert counts.sum() == self.N_BATCHES
        # chi-square against uniform: 99.9% critical value for df=4 is 18.47
        expected = self.N_BATCHES / L_MAX
        chi2 = float(((counts - expected) ** 2 / expected).sum())
        assert chi2 < 18.47, f"fake buckets not uniform: {counts}"

    def test_fake_independent_of_real(self, batches):
        """The fake draw must not follow the real bucket (that's 'matched')."""
        _, bs = batches
        reals = np.array([b["real_lengths"][0] for b in bs])
        fakes = np.array([b["fake_lengths"][0] for b in bs])
        match_rate = float((reals == fakes).mean())
        # independence -> P(match) = sum_b P(real=b)/L; far below 0.5.
        assert 0.02 < match_rate < 0.45

    def test_real_bucket_population_weighted(self, batches):
        """data_utils.py:40-49: real bucket ~ bucket populations."""
        t, bs = batches
        reals = np.array([b["real_lengths"][0] for b in bs])
        counts = np.bincount(reals, minlength=L_MAX + 1)[1:]
        pops = np.array([len(t.dataset.labels[b]) for b in range(1, L_MAX + 1)])
        expected = self.N_BATCHES * pops / pops.sum()
        chi2 = float(((counts - expected) ** 2 / np.maximum(expected, 1)).sum())
        assert chi2 < 18.47, f"real buckets not population-weighted: {counts}"

    def test_lengths_ride_as_data(self, batches):
        """True lengths are batch DATA (per-sample int arrays), never shapes:
        labels are padded to L_MAX with the pad id beyond the true length."""
        t, bs = batches
        pad_id = t.cfg.io.n_classes
        for b in bs[:20]:
            lf = int(b["fake_lengths"][0])
            assert b["fake_labels"].shape == (B, L_MAX)
            assert (b["fake_labels"][:, lf:] == pad_id).all()
            assert (b["fake_labels"][:, :lf] != pad_id).all()


class TestMatchedPairingContrast:
    def test_matched_follows_real(self, data, tmp_path_factory):
        t = _trainer(data, tmp_path_factory, bucket_pairing="matched")
        bs = [t._assemble() for _ in range(50)]
        for b in bs:
            assert (b["real_lengths"] == b["fake_lengths"]).all()
