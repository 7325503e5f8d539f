from .engine import InferenceEngine, RequestHandle, ServeResult

__all__ = ["InferenceEngine", "RequestHandle", "ServeResult"]
