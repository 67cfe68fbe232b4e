"""Command-line entry points of the port (`python -m denseclip_vit_multimodal_tpu_torch.tools.<name>`)."""
