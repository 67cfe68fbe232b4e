"""Host-side helpers of the port: PNG coding and colour panels (numpy and zlib only)."""
