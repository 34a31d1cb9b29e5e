"""Self-normalizing genomics encoder (counterpart of
``disentangled_multimodal_learning_tpu/models/maxnet.py:16``): four
[Linear -> ELU -> AlphaDropout] blocks (64/48/32 -> omic_dim), ReLU head,
linear classifier.  In train mode AlphaDropout(dropout_rate) is live, with
torch's semantics, which JAX ``alpha_dropout`` (``layers.py:33-43``)
reproduces; in eval it is the identity.  The classifier is kept because the
exported weights carry it."""

from __future__ import annotations

from torch import nn


class MaxNet(nn.Module):
    def __init__(self, input_dim: int = 59, omic_dim: int = 32,
                 dropout_rate: float = 0.25, label_dim: int = 1):
        super().__init__()
        dims = [input_dim, 64, 48, 32, omic_dim]
        self.encoder = nn.Sequential(*[
            nn.Sequential(nn.Linear(dims[i], dims[i + 1]), nn.ELU(),
                          nn.AlphaDropout(dropout_rate))
            for i in range(4)])
        self.classifier = nn.Sequential(nn.Linear(omic_dim, label_dim))

    def forward(self, x_omic):
        features = self.encoder(x_omic).relu()
        return features, self.classifier(features)
