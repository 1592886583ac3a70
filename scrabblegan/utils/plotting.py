"""Offline loss-curve plotting from training summaries.

Capability parity with utilities.py (reference utilities.py:8-67): read
batch_summary.csv, average per epoch, and emit discriminator / recognizer-generator
/ recognizer loss-curve PNGs, plus optional per-batch plots. Unlike the reference
(SURVEY.md defect #9 — its plotter expects a CSV the train loop never writes), this
consumes exactly the CSV scrabblegan.train.metrics.SummaryWriter produces.
"""

from __future__ import annotations

import os


def plot_losses(base_path: str, info_per_batch: bool = True,
                gradient_balance: bool = False) -> list:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd

    df = pd.read_csv(os.path.join(base_path, "batch_summary.csv"))
    df_mean = df.groupby("epoch").mean().reset_index()
    outputs = []

    def _plot(frame, x, ys, name):
        frame.plot(x=x, y=ys)
        out = os.path.join(base_path, name)
        plt.savefig(out)
        plt.clf()
        outputs.append(out)

    _plot(df_mean, "epoch", ["disc_loss", "disc_loss_fake", "disc_loss_real"],
          "disc_loss_vis_per_epoch.png")
    if gradient_balance:
        _plot(df_mean, "epoch",
              ["r_loss_fake", "g_loss", "r_loss_balanced", "g_loss_final",
               "r_loss_fake_std", "g_loss_std"],
              "rec_gen_vis_per_epoch.png")
        _plot(df_mean, "epoch",
              ["r_loss_fake", "r_loss_real", "r_loss_balanced",
               "r_loss_fake_std", "g_loss_std"],
              "rec_loss_vis_per_epoch.png")
    else:
        _plot(df_mean, "epoch", ["r_loss_fake", "g_loss", "g_loss_final"],
              "rec_gen_vis_per_epoch.png")
        _plot(df_mean, "epoch", ["r_loss_fake", "r_loss_real"],
              "rec_loss_vis_per_epoch.png")

    if info_per_batch:
        dfb = df.astype({"batch": "int32"}).reset_index()
        _plot(dfb, "index", ["disc_loss", "disc_loss_fake", "disc_loss_real"],
              "disc_loss_vis_per_batch.png")
    return outputs
