"""scrabblegan — a JAX/XLA framework for adversarial handwritten-text
generation with the full capabilities of the TF2 ScrabbleGAN reference
(UtkuKaradeniz/scrabble-gan; arXiv:2003.10557 plus the fork's style-promoter and
style-encoder extensions).

This is a from-scratch, idiomatic JAX design — a small flax.linen-style module
layer (scrabblegan/nn.py) over parameter pytrees, optax optimizers, a single
jitted multi-network train step, data parallelism over a `jax.sharding.Mesh`,
numpy checkpoint/resume, and a Pallas (Triton) kernel for the attention hot
path on NVIDIA GPUs. It is NOT a port of the reference's
Keras/GradientTape code; see SURVEY.md for the capability blueprint.
"""

__version__ = "0.1.0"
