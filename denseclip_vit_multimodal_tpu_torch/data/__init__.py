"""Data helpers of the port (normalisation; the data pipeline is not ported yet)."""
