from .quants import (
    FloatType,
    Q_BLOCK,
    quantize_q40,
    dequantize_q40,
    quantize_q80,
    dequantize_q80,
    unpack_q40,
    tensor_bytes,
)
from .mfile import ArchType, HiddenAct, RopeType, ModelHeader, MFileReader, MFileWriter
from .tfile import TokenizerData, read_tfile, write_tfile
