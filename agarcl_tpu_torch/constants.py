"""Game-rule constants.

A copy of agarcl_tpu/constants.py (the values of the reference tuning
macros, settings.hpp:1-51 and Entities.hpp:9-18): the port cannot import the
JAX package, whose __init__ pulls in JAX. tests/test_torch_config.py checks
that every value matches.
"""

# --- cell dynamics (settings.hpp:5-13) ---
CELL_MIN_SIZE = 25          # minimum cell mass
CELL_MAX_SPEED = 300.0      # numerator of the speed law: v_max = 300 / m^0.439
CELL_SPLIT_MINIMUM = 50     # minimum mass to split
SPLIT_DECELERATION = 80.0   # splitting-velocity decay (units/s^2)

FOOD_SPEED = 100.0          # ejected-mass launch speed
FOOD_DECEL = 80.0           # ejected-mass deceleration

RECOMBINE_TICKS = 300       # pinned: RECOMBINE_TIMER_SEC(10) * 30 ticks/s (SPEC D3)
# Merge-touch slack (SPEC M7 amendment): the reference's in-place sequential
# relax leaves expired pairs exactly tangent, so its `touches()` (>=) merge
# fires at first timer expiry (Engine.hpp:1160-1179 + avoid_static_overlap);
# our Jacobi relax leaves a strictly positive ~1e-4..1e-2 gap (drift harness,
# drift/recombine_probe.py), which would park side-by-side pairs unmerged
# forever. Merging within 0.01 world units of tangency restores the
# reference's observable behavior (merge ~= first expiry tick when adjacent).
RECOMBINE_TOUCH_EPS = 0.01

CELL_EAT_MARGIN = 1.1       # must be 1.1x larger to eat (settings.hpp:18)

# --- virus pop (settings.hpp:24-25) ---
CELL_POP_REDUCTION = 2.0
CELL_POP_SIZE = 25

# --- arena defaults (settings.hpp:27-31) ---
DEFAULT_ARENA_WIDTH = 250
DEFAULT_ARENA_HEIGHT = 250
DEFAULT_NUM_PELLETS = 500
DEFAULT_NUM_VIRUSES = 10
PLAYER_CELL_LIMIT = 14

# --- split conditions (settings.hpp:34-36) ---
NUM_CELLS_TO_SPLIT = PLAYER_CELL_LIMIT
MIN_CELL_SPLIT_MASS = 130

# --- mass decay (settings.hpp:39-41) ---
PLAYER_DECAY_RATE = 0.002
DECAY_TICKS = 60            # decay applies when elapsed - last_decay >= 60

# --- virus feeding (settings.hpp:44) ---
NUMBER_OF_FOOD_HITS = 7

# --- auto-split (settings.hpp:47-48) ---
MAX_MASS_IN_THE_GAME = 22500
NEW_MASS_IF_NO_SPLIT = 22000

# --- anti-teaming (settings.hpp:51-52) ---
ANTI_TEAM_ACTIVATION_TICKS = 60 * 60   # one minute of player ticks (Engine.hpp:551)

# --- entity masses (Entities.hpp:9-18) ---
PELLET_MASS = 1
FOOD_MASS = 10
VIRUS_INITIAL_MASS = 100
CELL_EAT_REQUIREMENT = 25   # a cell must exceed this mass to eat other cells

# --- cadences (Engine.hpp:498,231; BaseEnvironment.hpp:13-14) ---
BOT_ACTION_PERIOD = 10      # bots re-decide every 10 engine ticks
REGEN_PERIOD = 120          # pellet/virus regeneration every 120 ticks
DEFAULT_DT = 1.0 / 30.0     # nominal simulation timestep
FEED_COOLDOWN = 10          # ticks (Engine.hpp:1052)
SPLIT_COOLDOWN = 30         # ticks (Engine.hpp:1063)

# --- env action scale (BaseEnvironment.hpp:170-171) ---
TARGET_ACTION_SCALE = 10.0  # target = centroid + 10 * (dx, dy)

# --- bot perception radii (HungryShyBot.hpp:6, AggressiveBot.hpp:6) ---
SHY_RADIUS = 25.0
AGGRESSIVE_RADIUS = 20.0

# --- mode-3 termination (BaseEnvironment.hpp:357) ---
MODE3_MAX_MASS = 23000

# --- pinned capacities (SPEC.md "Capacities") ---
MAX_CELLS_PER_PLAYER = 16
VIRUS_HEADROOM = 16
FOOD_CAPACITY = 128
VIRUS_TICKS_CAPACITY = 16
