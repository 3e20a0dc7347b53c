"""Deploy layer (L7): CRD-shaped deployment spec → k8s manifests that run
the port.  A copy of the JAX package's ``deploy/``.

Reference counterpart: deploy/dynamo/operator (DynamoDeployment CRD +
controller), deploy/helm.  See deploy/k8s/crd.yaml and renderer.py."""

from .renderer import render, render_to_yaml, shell_preview  # noqa: F401
