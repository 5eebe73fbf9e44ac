"""Plain PyTorch references that decide ``correct``.  They import nothing of
the program under test, and take from it only the outputs they judge."""
