from scrabblegan.train.state import ModelBundle, TrainState, build_models, create_train_state
from scrabblegan.train.step import make_train_step, METRIC_NAMES

__all__ = [
    "ModelBundle",
    "TrainState",
    "build_models",
    "create_train_state",
    "make_train_step",
    "METRIC_NAMES",
]
