"""Deployment: ahead-of-time export of the inference programs
(``torch.export``), an HTTP server over an exported artifact, and
ahead-of-run kernel builds."""

from adlm_tpu_torch.deploy.export import (  # noqa: F401
    export_inference_artifact,
    load_inference_artifact,
)

__all__ = ["export_inference_artifact", "load_inference_artifact"]
