"""The paper's algorithms in eager PyTorch: EFTs, the FF pair type and its
operators, compensated reductions, FF exp/log, the precision policy."""
