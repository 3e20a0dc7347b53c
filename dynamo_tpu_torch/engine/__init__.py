"""TorchEngine and its host-side scheduler / KV manager."""
