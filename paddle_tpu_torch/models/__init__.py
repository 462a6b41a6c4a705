"""Models of the port (the transformer LM, for serving)."""
