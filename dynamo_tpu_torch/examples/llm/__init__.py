"""The example LLM app (the JAX package's ``examples/llm``) on the port."""
