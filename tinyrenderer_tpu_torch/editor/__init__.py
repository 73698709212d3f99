"""Editor parameter reflection (``params.ui_param``), the field metadata
the scene components and the camera carry."""
