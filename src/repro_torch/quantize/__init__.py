"""The dual approximation of `repro.quantize`: the popcount snap table the
printed-MLP family decodes through, and the LM weight quantization
(per-tensor bits and margin genes, float emulation)."""
from repro_torch.quantize.bespoke import (
    apply_chromosome, dequantize_tensor, make_lm_quant_problem,
    quantizable_tensors, quantize_tensor, snap_lut, tensor_cost,
)

__all__ = ["snap_lut", "quantize_tensor", "dequantize_tensor", "tensor_cost",
           "quantizable_tensors", "apply_chromosome",
           "make_lm_quant_problem"]
