from scrabblegan.eval.fid import (
    compute_rfid,
    frechet_distance,
    random_features,
    recognizer_features,
)
from scrabblegan.eval.decode import greedy_ctc_decode, character_error_rate
from scrabblegan.eval.gate import (
    annotate_export,
    latest_good_export,
    score_export,
)

__all__ = [
    "frechet_distance",
    "recognizer_features",
    "random_features",
    "compute_rfid",
    "greedy_ctc_decode",
    "character_error_rate",
    "score_export",
    "annotate_export",
    "latest_good_export",
]
