"""The benchmark of scene_graph_commonsense_torch (see README.md)."""
