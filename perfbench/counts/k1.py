"""K1, the fused Douglas march of a Heston book
(``csrc/adi_fused_batched.cu``): B options, each on an (nS, nv) grid,
nT steps, float32.

Operations a node and step: the explicit operators A0 (a four-point
difference and its coefficient, 4), A1 and A2 (three products and two sums
each, 10) and their sum with V (three products, three sums, 6); the S
sweep on its factored system (forward 3, back 2); the second right-hand
side from A2 V (2); the v sweep (5): 32.  Factoring the S systems once
adds 3 a node.  The bands' set-up (a few tens of operations a variance
level and option) and the Dirichlet edges are under 0.1% and left out.

Bytes: the nine numbers that define an option's march (kappa, theta,
sigma, rho, r, q, T, K, call or put) in, the grid V(t = 0) out, 4 bytes
each."""

KERNEL = "douglas_march"


def flops(s: dict) -> float:
    nodes = s["B"] * s["nS"] * s["nv"]
    return 32.0 * nodes * s["nT"] + 3.0 * nodes


def bytes_moved(s: dict) -> float:
    return 4.0 * (9 * s["B"] + s["B"] * s["nS"] * s["nv"])
