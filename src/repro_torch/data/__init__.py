from .synthetic import make_batch, token_stream  # noqa: F401
