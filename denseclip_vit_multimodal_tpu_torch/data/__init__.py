"""Data pipeline of the port: synthetic dataset, threaded loader, on-device augmentation."""
