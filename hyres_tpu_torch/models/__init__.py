from .checkerboard import LightWeightCheckerboard
from .cheng2020 import Cheng2020withCheckerboard
from .cheng_codec import Cheng2020Codec
from .codec import CheckerboardCodec
from .elic import LightWeightELIC
from .elic_codec import ElicCodec
from .hyres import HyresCodec, ResidualJPEGCompression
from .tcm import TCM
from .tcm_codec import TcmCodec

__all__ = ["CheckerboardCodec", "Cheng2020Codec", "Cheng2020withCheckerboard",
           "ElicCodec", "HyresCodec", "LightWeightCheckerboard", "LightWeightELIC",
           "ResidualJPEGCompression", "TCM", "TcmCodec"]
