"""Nodes of the captured step's graphs that a frame step replays once
each (head and tail), counted by the CUDA driver API's cuGraphGetNodes
through the session's step graphs; nothing where PyTorch does not hand
out the raw graphs."""


def read(ctx):
    return ctx["counters"].get("graph_nodes_per_step")
