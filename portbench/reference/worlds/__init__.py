"""The benchmark's world builders, one module a kind: ``<kind>.py`` exposes
``build(sizes, seed=None) -> World`` (`portbench.reference.chain.World`).
A configuration file names its kind under ``world``; the registry finds the
module by that name, so a new kind is a new file here.
"""
