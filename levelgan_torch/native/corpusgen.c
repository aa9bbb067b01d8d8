/* Native batch corpus generator — the host data-loader's hot path in C.
 *
 * Reference equivalent: none (the reference is pure Python; SURVEY.md §2.1
 * "Native components in the reference: NONE").  This is the levelgan
 * native runtime tier for the HOST side: corpus generation is the one
 * Python-loop-bound piece of the pipeline (per-level drunkard-walk carving),
 * and large corpora (10^5+ levels) make it a real cost.  The algorithm
 * mirrors levelgan/data/dataset.py::_carve_level: border walls, a connected
 * random-walk-carved floor (playable by construction), GOAL at the farthest
 * carved cell (L1) from START, hazard/coin/terrain decoration.
 *
 * RNG: splitmix64 -> xoshiro256** (own stream; corpora are deterministic in
 * the seed but are a distinct backend from the NumPy PCG path — select with
 * DataConfig.corpus = "synthetic_native").
 *
 * Built by levelgan/native/build.py with the system cc into _corpusgen.so,
 * bound via ctypes (no pybind11 in this image).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define EMPTY 0
#define WALL 1
#define START 2
#define GOAL 3
#define HAZARD 4
#define COIN 5
#define SAND 6
#define ICE 7

/* ---- xoshiro256** seeded via splitmix64 -------------------------------- */
typedef struct { uint64_t s[4]; } rng_t;

static uint64_t splitmix64(uint64_t *x) {
    uint64_t z = (*x += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
}

static void rng_seed(rng_t *r, uint64_t seed) {
    for (int i = 0; i < 4; i++) r->s[i] = splitmix64(&seed);
}

static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
}

static uint64_t rng_next(rng_t *r) {
    uint64_t *s = r->s;
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3];
    s[2] ^= t; s[3] = rotl(s[3], 45);
    return result;
}

static inline double rng_double(rng_t *r) {
    return (double)(rng_next(r) >> 11) * (1.0 / 9007199254740992.0);
}

static inline int rng_below(rng_t *r, int n) {
    return (int)(rng_next(r) % (uint64_t)n);
}

/* ---- one level ---------------------------------------------------------- */
static void carve_level(rng_t *r, int size, double wall_density,
                        double hazard_rate, double coin_rate,
                        uint8_t *grid, int32_t *carved /* scratch 2*size*size */) {
    const int interior = size - 2;
    memset(grid, WALL, (size_t)size * size);

    int target = interior * interior * (1.0 - wall_density) + 0.5;
    if (target < 4) target = 4;

    int row = 1 + rng_below(r, size - 2);
    int col = 1 + rng_below(r, size - 2);
    const int sr = row, sc = col;
    grid[row * size + col] = EMPTY;
    carved[0] = row; carved[1] = col;
    int n_carved = 1;

    static const int dr[4] = {0, 0, 1, -1};
    static const int dc[4] = {1, -1, 0, 0};
    long max_steps = 50L * interior * interior;
    for (long step = 0; n_carved < target && step < max_steps; step++) {
        int d = rng_below(r, 4);
        int nr = row + dr[d], nc = col + dc[d];
        if (nr >= 1 && nr < size - 1 && nc >= 1 && nc < size - 1) {
            row = nr; col = nc;
            if (grid[row * size + col] == WALL) {
                grid[row * size + col] = EMPTY;
                carved[2 * n_carved] = row;
                carved[2 * n_carved + 1] = col;
                n_carved++;
            }
        }
    }

    /* goal: farthest carved cell (L1) from start */
    int best = 0, best_d = -1;
    for (int i = 0; i < n_carved; i++) {
        int d = abs(carved[2 * i] - sr) + abs(carved[2 * i + 1] - sc);
        if (d > best_d) { best_d = d; best = i; }
    }
    int gr = carved[2 * best], gc = carved[2 * best + 1];
    if (gr == sr && gc == sc && n_carved > 1) {
        gr = carved[2 * (n_carved - 1)];
        gc = carved[2 * (n_carved - 1) + 1];
    }

    /* decorations on floor cells (never start/goal) */
    for (int i = 0; i < n_carved; i++) {
        int cr = carved[2 * i], cc = carved[2 * i + 1];
        if ((cr == sr && cc == sc) || (cr == gr && cc == gc)) continue;
        double u = rng_double(r);
        double t = rng_double(r);
        uint8_t *cell = &grid[cr * size + cc];
        if (u < hazard_rate) *cell = HAZARD;
        else if (u < hazard_rate + coin_rate) *cell = COIN;
        else if (t < 0.08) *cell = SAND;
        else if (t < 0.16) *cell = ICE;
    }

    grid[sr * size + sc] = START;
    grid[gr * size + gc] = GOAL;
}

/* ---- public entry -------------------------------------------------------
 * out: caller-allocated n*size*size uint8 buffer. Returns 0 on success.
 * rate_oversample: fraction of levels whose hazard/coin multipliers draw
 * from the top quartile of the [0,2] band (round-5 conditional-band
 * widening; 0.0 draws nothing extra, keeping old seeds bit-identical). */
int gen_levels(uint64_t seed, int64_t n, int32_t size, double wall_density,
               double hazard_rate, double coin_rate, double rate_oversample,
               uint8_t *out) {
    if (size < 4 || n < 0) return -1;
    rng_t r;
    rng_seed(&r, seed);
    int32_t *carved = (int32_t *)malloc(sizeof(int32_t) * 2u * size * size);
    if (!carved) return -2;
    for (int64_t i = 0; i < n; i++) {
        /* per-level density spread around the centers (matches the NumPy
         * backend's feature-diversity contract for conditioning) */
        double wd = (0.6 + rng_double(&r)) * wall_density;
        if (wd < 0.05) wd = 0.05;
        if (wd > 0.55) wd = 0.55;
        double hr, cr;
        if (rate_oversample > 0.0 && rng_double(&r) < rate_oversample) {
            hr = (1.5 + 0.5 * rng_double(&r)) * hazard_rate;
            cr = (1.5 + 0.5 * rng_double(&r)) * coin_rate;
        } else {
            hr = 2.0 * rng_double(&r) * hazard_rate;
            cr = 2.0 * rng_double(&r) * coin_rate;
        }
        carve_level(&r, size, wd, hr, cr,
                    out + (size_t)i * size * size, carved);
    }
    free(carved);
    return 0;
}
