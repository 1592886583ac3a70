"""Real-IAM readiness kit (VERDICT r3 item 8): configs/iam_campaign.json must
drive the EXACT training path docs/IAM.md prescribes, on the synthetic
stand-in (`--synthetic` swaps only the data source). This is the checked-in
proof that the environment-blocked real-data campaign is a one-command run
the day IAM lands."""

import json
import os

import pytest

pytestmark = pytest.mark.slow  # jits the padded multi-network step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "iam_campaign.json")


class TestIamCampaignConfig:
    def test_config_encodes_reference_schedule_and_regime(self):
        """Fast sanity on the checked-in JSON: reference schedule constants
        (scrabble_gan.gin:17-18,36) + the quality-recommended regime
        (docs/QUALITY.md)."""
        from scrabblegan.config import load_config

        cfg = load_config(CONFIG)
        assert cfg.io.buf_size == 80377  # 5,024 steps/epoch at batch 16
        assert cfg.shared.batch_size == 16
        assert cfg.shared.epochs == 10
        assert cfg.parallel.shape_mode == "padded"
        # reference fake-bucket semantics (data_utils.py:385-387)
        assert cfg.parallel.bucket_pairing == "independent"
        assert cfg.optimizer.g_ema_decay > 0  # recommended serving regime
        assert cfg.io.dataset == "iam"

    def test_synthetic_dry_run_of_campaign_path(self, tmp_path):
        """docs/IAM.md §5: the campaign config trains end-to-end on the
        synthetic stand-in at tiny sizes — same code path as real IAM minus
        the converter."""
        import train

        workdir = str(tmp_path / "iam_dry")
        rc = train.main([
            "--config", CONFIG, "--synthetic", "--workdir", workdir,
            "--epochs", "1", "--batches-per-epoch", "2",
            "--set", "io.bucket_size=3", "--set", "shared.batch_size=4",
            "--set", "io.buf_size=8", "--set", "shared.num_gen=4",
            "--set", "io.stall_timeout_s=0",
        ])
        assert rc == 0
        # campaign-regime artifacts: grid, export, full-state checkpoint, and
        # a self-describing config.json recording the padded+EMA regime
        assert os.path.exists(os.path.join(workdir, "output",
                                           "image_at_epoch_0001.png"))
        assert os.path.isdir(os.path.join(workdir, "model", "generator", "1"))
        with open(os.path.join(workdir, "config.json")) as f:
            persisted = json.load(f)
        assert persisted["parallel"]["shape_mode"] == "padded"
        assert persisted["optimizer"]["g_ema_decay"] > 0
