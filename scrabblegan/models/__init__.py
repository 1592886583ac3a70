from scrabblegan.models.generator import Generator, StyleEncoder, gen_channels
from scrabblegan.models.discriminator import Discriminator, DCGANDiscriminator, disc_channels
from scrabblegan.models.recognizer import Recognizer, BiLSTMRecognizer, ctc_time_steps
from scrabblegan.models.style import StylePromoter, StyleExtractor

__all__ = [
    "Generator",
    "StyleEncoder",
    "gen_channels",
    "Discriminator",
    "DCGANDiscriminator",
    "disc_channels",
    "Recognizer",
    "BiLSTMRecognizer",
    "ctc_time_steps",
    "StylePromoter",
    "StyleExtractor",
]
