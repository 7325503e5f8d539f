from .quantization import QuantizedDense, quantize_net

__all__ = ["QuantizedDense", "quantize_net"]
