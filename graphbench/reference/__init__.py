"""The plain reference: a NumPy subgraph matcher of the port's query
semantics, working from the benchmark's own arrays (``matcher.py``)."""
