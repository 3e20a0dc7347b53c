"""Token-level request/response protocols."""
