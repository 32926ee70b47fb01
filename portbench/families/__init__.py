"""How the benchmark drives each family of configurations through the
program under test, and through the plain reference.

A configuration's file names its `family`; `portbench/families/<family>.py`
holds what is particular to it: the program's model built around the
benchmark's weights, its served task and its training loss, the reference's
forward and loss on the same inputs, and the count of its operations. A new
configuration of a known family is a new file under `portbench/configs/`
alone.
"""
