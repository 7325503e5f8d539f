from .engine import InferenceEngine, RequestHandle, ServeResult
from .grammar import TokenGrammar, clear_grammar_cache, compile_grammar, schema_regex
from .speculate import constrain_draft, draft_from_history

__all__ = ["InferenceEngine", "RequestHandle", "ServeResult", "TokenGrammar",
           "compile_grammar", "schema_regex", "clear_grammar_cache",
           "draft_from_history", "constrain_draft"]
