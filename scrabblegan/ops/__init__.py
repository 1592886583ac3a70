from scrabblegan.ops.layers import SNConv, SNConvTranspose, SNDense, orthogonal_init
from scrabblegan.ops.blocks import ConditionalBatchNorm, ResNetBlockUp, ResNetBlockDown
from scrabblegan.ops.attention import NonLocalBlock
from scrabblegan.ops.embedding import FilterBank
from scrabblegan.ops.losses import hinge, not_saturating, get_loss_fn, LOSS_REGISTRY
from scrabblegan.ops.ctc import ctc_loss
from scrabblegan.ops.balance import gradient_balance

__all__ = [
    "SNConv",
    "SNConvTranspose",
    "SNDense",
    "orthogonal_init",
    "ConditionalBatchNorm",
    "ResNetBlockUp",
    "ResNetBlockDown",
    "NonLocalBlock",
    "FilterBank",
    "hinge",
    "not_saturating",
    "get_loss_fn",
    "LOSS_REGISTRY",
    "ctc_loss",
    "gradient_balance",
]
