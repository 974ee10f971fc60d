"""Core: type descriptors, graph, compiled problem, LM loops."""
