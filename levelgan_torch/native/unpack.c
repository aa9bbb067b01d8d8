/* Bit-plane unpacker: the export path's host loop in C.
 *
 * The export packs tile ids on the device to ceil(log2(n_tiles)) bit
 * planes (levelgan_torch/export.py, pack_levels); the host unpacks
 * [n, hw/8 groups, bits planes] bytes back to one uint8 tile id per cell
 * in one pass over the packed bytes, with a 256-entry "bit spread" table:
 * one load, shift and OR per plane per 8-tile group, then one 8-byte
 * store.
 *
 * Layout contract (pack_levels and unpack_levels_plain in export.py):
 * packed[g*bits + j] holds plane j of group g; bit k of that byte is bit j
 * of tile (g*8 + k), little-endian.
 *
 * Built by levelgan_torch/native/build.py with the system cc and bound
 * with ctypes.
 */

#include <stdint.h>
#include <string.h>

/* spread8[v] = uint64 whose byte k equals bit k of v (0 or 1) */
static uint64_t spread8[256];
static int spread_ready = 0;

static void init_spread(void) {
    for (int v = 0; v < 256; v++) {
        uint64_t w = 0;
        for (int k = 0; k < 8; k++)
            if (v & (1 << k)) w |= 1ULL << (8 * k);
        spread8[v] = w;
    }
    spread_ready = 1;
}

/* packed: n_groups * bits bytes; out: n_groups * 8 bytes. Returns 0. */
int unpack_planes(const uint8_t *packed, int64_t n_groups, int32_t bits,
                  uint8_t *out) {
    if (!spread_ready) init_spread();
    if (bits < 1 || bits > 8) return 1;
    { /* the memcpy store relies on little-endian byte order */
        const uint16_t probe = 1;
        if (*(const uint8_t *)&probe != 1) return 2;
    }
    for (int64_t g = 0; g < n_groups; g++) {
        const uint8_t *p = packed + g * bits;
        uint64_t w = spread8[p[0]];
        for (int32_t j = 1; j < bits; j++)
            w |= spread8[p[j]] << j;
        memcpy(out + g * 8, &w, 8); /* little-endian byte k = tile g*8+k */
    }
    return 0;
}
