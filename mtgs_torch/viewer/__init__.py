"""Interactive scene viewer (stdlib-only HTTP, no viser dependency); port of
`mtgs_tpu/viewer/`."""

from mtgs_torch.viewer.server import ViewerServer
