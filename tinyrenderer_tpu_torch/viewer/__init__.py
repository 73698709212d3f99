"""Browser-based viewer/editor front-end (the winit window + egui panel
replacement for headless GPU hosts)."""

from .server import ViewerServer  # noqa: F401
