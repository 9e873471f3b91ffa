"""The plain reference that decides ``correct``: a frozen copy of the
port's plain PyTorch path (``bilevel_gait_gen_tpu_torch`` as of the
benchmark's first commit), cut to what the cells run: the A1 model and its
dynamics (``a1``, ``rbd``, ``srb``, ``quat``, ``spline``), the real-time
iteration (``gait``, ``trajectory``, ``qp``, ``pdip``, ``solver``), the
gait update (``bilevel``), the controller (``ik``, ``wbqp``,
``mpc_controller``) and the closed loop's period (``engine``), with the
starts of the cells (``start``).

What the copy leaves out of the port: every hand-written kernel (the
products are ``@``, every interior-point sweep is the unrolled tensor-code
sweep that the fused kernel computes), the ADMM backend, the lanes sharded
over processes, the CUDA graphs, and the float32 precision switches (the
caller sets them: the control runs this code in TF32).  It imports nothing
of the port, of JAX or of the JAX package, and a change of the port does
not move it.
"""
