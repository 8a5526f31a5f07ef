"""Plain references the benchmark holds the program to: a model family's
forward pass (``decoder``, named by a configuration file's ``reference``)
and the warm pool's keep-alive rules (``pool``). They import nothing of the
program."""
