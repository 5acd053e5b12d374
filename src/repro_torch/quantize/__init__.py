"""Hardware-friendly value snapping (`bespoke.snap_lut`), the part of
`repro.quantize` the printed-MLP family decodes through. The LM weight
quantization of that package is a later slice of the port."""
from repro_torch.quantize.bespoke import snap_lut

__all__ = ["snap_lut"]
