"""Serving of the port: the continuous-batching LLM engine (``llm``), its
prefix/page pools (``prefix_cache``) and the prefill tier (``kv_transfer``)."""
