"""Host-side helpers of the port: PNG coding, colour panels, timing, FLOP accounting and
the environment report."""
