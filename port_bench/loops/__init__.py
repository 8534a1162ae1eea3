"""The closed loops, one module each, named by the traffic files'
`loop` key (see port_bench/loop.py)."""
