"""Command-line tools of the port (``python -m dynamo_tpu_torch.tools.<name>``)."""
