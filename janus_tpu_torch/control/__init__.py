"""Outer solvers and their building blocks (the ported subset: the Krylov
preconditioners of ``control.precond``)."""
