"""Runnable examples of the port, each the twin of the reference's
``examples/<name>.py``: ``python3 -m janus_tpu_torch.examples.<name>``.

- ``stiff_vdp_batch``: 65,536 stiff Van der Pol lanes in one batch;
- ``sharded_sweep``: the batch split over processes (``parallel``);
- ``train_nn_hamiltonian``: a neural Hamiltonian through ``odeint_fixed``;
- ``learned_continuation``: a learned homotopy step controller;
- ``reverse_time``: integration with tf < t0;
- ``hamiltonian_vdp``: dynamics and sensitivities from a scalar H;
- ``events_poincare``: batched Poincaré-section crossing times;
- ``fit_mu_gauss_newton``: Gauss–Newton with IND parameter Jacobians;
- ``bratu_psitc``: Ψtc and Newton–Krylov on the Bratu problem;
- ``dubins_pmp``: Dubins-car PMP shooting with an ε homotopy;
- ``vdp_pmp_energy``: single and multiple shooting, homotopy in μ;
- ``event_time_training``: gradient descent on event times;
- ``neural_ode_dopri``: a neural ODE through adaptive dopri5;
- ``newton_cg_hvp``: Newton-CG with ``radau_hvp`` curvature;
- ``vdp_min_time``: free-final-time PMP over a grid of control bounds.
"""
