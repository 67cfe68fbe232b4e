"""Data pipeline of the port: synthetic, Cityscapes and ADE20K datasets, threaded loader, on-device augmentation."""
