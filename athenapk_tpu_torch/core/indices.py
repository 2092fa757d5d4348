"""Variable index conventions.

Mirrors the reference layout (AthenaPK ``src/main.hpp:19-33``): conserved
vector is [rho, m1, m2, m3, E, (B1, B2, B3, psi), scalars...]; the primitive
vector shares slots with [rho, v1, v2, v3, p, (B1, B2, B3, psi), scalars...].
"""

IDN = 0
IM1 = 1
IM2 = 2
IM3 = 3
IEN = 4
NHYDRO = 5
IB1 = 5
IB2 = 6
IB3 = 7
IPS = 8
NGLMMHD = 9

# primitive aliases
IV1 = 1
IV2 = 2
IV3 = 3
IPR = 4

# Axis numbering for the 5-D block-batched state [block, var, z, y, x].
AXIS_X = 4
AXIS_Y = 3
AXIS_Z = 2

# direction ids (1-indexed like the reference's X1DIR..X3DIR)
X1DIR = 1
X2DIR = 2
X3DIR = 3

# Fluids
EULER = "euler"
GLMMHD = "glmmhd"


def nvar_for_fluid(fluid: str, nscalars: int = 0) -> int:
    base = NGLMMHD if fluid == GLMMHD else NHYDRO
    return base + nscalars
