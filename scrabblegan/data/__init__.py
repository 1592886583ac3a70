from scrabblegan.data.iam import init_reading, convert_to_gan_format
from scrabblegan.data.loaders import (
    BucketedDataset,
    encode_word,
    decode_label,
    load_random_word_list,
    load_style_images,
)
from scrabblegan.data.synthetic import make_synthetic_dataset

__all__ = [
    "init_reading",
    "convert_to_gan_format",
    "BucketedDataset",
    "encode_word",
    "decode_label",
    "load_random_word_list",
    "load_style_images",
    "make_synthetic_dataset",
]
