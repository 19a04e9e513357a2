"""Parameter specs and dense layers of the port."""
