"""Serving of the port's LM substrate (serve/decode.py)."""
