"""Port of ``repro.launch``: the production mesh, the dry-run, and the
train and serve entry points."""
