from mgpoisson_torch.solver.multigrid import MultigridPoisson, SolveResult

__all__ = ["MultigridPoisson", "SolveResult"]
