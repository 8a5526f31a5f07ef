"""Entry points: the training and serving launchers and the step builders
they share (the port of ``repro/launch``; the mesh and dry-run modules
come with ROADMAP Queue A item 6)."""
