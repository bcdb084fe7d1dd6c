"""Table generators, one module per family, named by a configuration's
``generator`` key. They make every column on the device from the seed
with plain torch and import nothing of the program."""
