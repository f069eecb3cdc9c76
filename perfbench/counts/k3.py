"""K3, the fused theta-scheme march of a local-vol book with time-varying
coefficients (``csrc/cn1d_tv_fused.cu``): B options, n nodes, nT steps,
float32.

The problem's input is the local vol at every node and time level, one
number each, (nT + 1) n B; the three operator bands a node follow from it
(8 operations a node and level: sigma^2, the diffusion and convection
coefficients, the three bands).  Operations a node and step: the explicit
part (three products, two sums) and the right-hand side (2), the implicit
coefficients (4), the Thomas factorisation fused with the forward sweep (7)
and the back substitution (2): 20, plus the 8 of its level.

Bytes: the vol lattice and each option's T, K and call or put in, V(t = 0)
out, 4 bytes each."""

KERNEL = "cn_march_tv"


def flops(s: dict) -> float:
    return 20.0 * s["B"] * s["n"] * s["nT"] + 8.0 * s["B"] * s["n"] * (s["nT"] + 1)


def bytes_moved(s: dict) -> float:
    return 4.0 * ((s["nT"] + 1) * s["n"] * s["B"] + 3 * s["B"] + s["n"] * s["B"])
