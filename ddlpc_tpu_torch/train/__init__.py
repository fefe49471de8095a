"""Adam, the Trainer and the CLI (``python -m ddlpc_tpu_torch.train``)."""
