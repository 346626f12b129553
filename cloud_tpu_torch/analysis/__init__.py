"""Analysis tools of the PyTorch port: so far the training half of the
deterministic fault injector (`chaos`)."""
