"""Multi-operand combine: the hierarchical allreduce's reduction arithmetic."""
