"""The plain reference of the benchmark's configurations: the hierarchical
model, its loss, its optimizer step and its evaluation, in plain PyTorch,
read from the configuration files alone.

Nothing here imports the program under test. Every table it needs (the
label hierarchy, the problem definition, the resize tables) comes from the
configuration file or is worked out here again.
"""
