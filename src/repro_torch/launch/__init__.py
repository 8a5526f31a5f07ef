"""Entry points: the training and serving launchers, the step builders
they share, the meshes and the multi-pod dry-run (the port of
``repro/launch``)."""
