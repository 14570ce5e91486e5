// Host-side UNet voxel-plan builder of the PyTorch port (a copy of
// mopa_build_plan3 in the JAX package's native/mopa_loader.cpp, with what it
// needs: pack_key, voxelize_level and the v3 wire encoder).
//
// Builds the whole per-sample sparse-UNet plan on the host CPU: per-level
// voxel tables, the wide-column submanifold ranks and dz-select codes, the
// stride-2 down/up maps and the point -> voxel inverse. The decoded plan
// (mopa_tpu_torch/models/scn_unet.py::plan_from_host_arrays) equals
// build_unet_plan_batched's per-sample plans: canonical (x, y, z)-
// lexicographic voxel order, the same overflow-drop policy, the same dz
// codes.
//
// Built at first use by the host C++ compiler into mopa_tpu_torch/_build/
// (data/native_loader.py): c++ -O3 -std=c++17 -shared -fPIC.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

constexpr int kShift = 4096;  // coordinate range per axis (12 bits)

inline uint64_t pack_key(int32_t x, int32_t y, int32_t z) {
    return ((uint64_t)(uint32_t)x << 24) | ((uint64_t)(uint32_t)y << 12) |
           (uint64_t)(uint32_t)z;
}

struct Level {
    std::vector<int32_t> coords;  // (V, 3) kept voxel coords
    std::vector<uint64_t> keys;   // (V,) sorted keys
    int32_t num = 0;
};

// Sorted-unique voxelisation of (coords, valid) with capacity overflow-drop.
// inverse: per input row, kept-voxel slot or -1.
void voxelize_level(const int32_t* coords, const uint8_t* valid, int n,
                    int cap, Level* out, int32_t* inverse,
                    int32_t* counts /* may be null */) {
    thread_local std::vector<std::pair<uint64_t, int32_t>> rows;
    rows.clear();
    rows.reserve(n);
    for (int i = 0; i < n; ++i) {
        if (!valid[i]) continue;
        const int32_t x = coords[i * 3], y = coords[i * 3 + 1],
                      z = coords[i * 3 + 2];
        if (x < 0 || x >= kShift || y < 0 || y >= kShift || z < 0 ||
            z >= kShift)
            continue;
        rows.emplace_back(pack_key(x, y, z), i);
    }
    // key-sorted input (train batches) skips the sort
    bool sorted = true;
    for (size_t i = 1; i < rows.size(); ++i)
        if (rows[i - 1].first > rows[i].first) { sorted = false; break; }
    if (!sorted) std::sort(rows.begin(), rows.end());
    out->coords.clear();
    out->keys.clear();
    if (counts) std::memset(counts, 0, sizeof(int32_t) * (size_t)cap);
    for (int i = 0; i < n; ++i) inverse[i] = -1;
    int slot = -1;
    uint64_t prev = ~0ull;
    for (auto& r : rows) {
        if (r.first != prev) {
            prev = r.first;
            ++slot;
            if (slot < cap) {
                out->keys.push_back(r.first);
                const int32_t* c = coords + (size_t)r.second * 3;
                out->coords.insert(out->coords.end(), {c[0], c[1], c[2]});
            }
        }
        if (slot < cap) {
            inverse[r.second] = slot;
            if (counts) counts[slot] += 1;
        }
    }
    out->num = (int32_t)out->keys.size();
}

}  // namespace

extern "C" {

// Build the full plan, delta-compressed for the wire (format v3).
//
// Per-column rank sequences are non-decreasing (sorted query keys merged into
// sorted tables), so they ship as 4-bit deltas that the decoder integrates
// with one cumsum; a miss holds the previous value (its gathered row is dead:
// the dz codes mask it), so monotonicity never breaks. Deltas > 14 saturate
// to 15 and ship the excess in a fixed-budget list of (unpacked position,
// excess) fixups that the decoder scatter-adds before the cumsum. The centre
// xy-column (dx = dy = 0) is not shipped: its window start is the voxel's own
// slot minus the below-z existence bit (rank = i - e0), so 8 of the 9
// columns ride the wire. The dz codes are functions of the three per-column
// existence bits, and a level's valid mask is slot < nums[l].
//
// Layout of the flat output buffers (caller-allocated):
//   rankn:  ceil(sum_l cap_l*8 / 2)  uint8: nibble-packed rank deltas,
//           row-major (cap, 8) over the 8 non-centre columns; unpacked
//           index f lives in byte f>>1, low nibble when f is even
//   ebits:  sum_l cap_l * 3          uint8, bit 3c'+j of the (cap, 3) row =
//           neighbour (non-centre column c', dz = j-1). The centre column
//           ships one bit (cbits): its dz=0 neighbour is the voxel itself
//           (slot < nums[l]) and its dz=+1 bit is the next row's dz=-1 bit
//   cbits:  sum_l ceil(cap_l / 8)    uint8, bit i%8 of byte i/8 = centre
//           column dz=-1 existence for voxel i
//   downn:  (sum_{l>=1} cap_l*8)/2   uint8 nibble-packed down-map deltas
//   downe:  sum_{l>=1} cap_l         uint8, bit o = child o exists
//   f2c:    sum_{l>=1} cap_{l-1}     int16 (-1 invalid; absolute: halving
//                                    each coordinate does not keep the
//                                    lexicographic order)
//   upoffn: ceil(sum_{l>=1} cap_{l-1} / 2)  uint8 nibble-packed octants
//   fix:    (fix_cap,) int32, (pos << 11) | excess with excess <= 2047; pos
//           indexes the virtual unpacked-nibble concatenation
//           [rankn | downn] (pos < 2^21). Excesses > 2047 split across
//           entries at the same pos (the decoder's scatter-add sums them).
//           Unused entries are -1
//   nums:   num_levels int32 (kept voxels per level)
//   inverse: (n,) int32; counts: (cap_0,) int32
// Returns 0 on success, -1 on bad arguments, -2 on fixup overflow.
int mopa_build_plan3(const int32_t* coords, const uint8_t* valid, int n,
                     int num_levels, const int32_t* caps, int32_t* inverse,
                     int32_t* counts, uint8_t* rankn, uint8_t* ebits,
                     uint8_t* cbits, uint8_t* downn, uint8_t* downe,
                     int16_t* f2c, uint8_t* upoffn, int32_t* fix, int fix_cap,
                     int32_t* nums) {
    if (n <= 0 || num_levels <= 0 || fix_cap <= 0) return -1;
    size_t sum8r = 0, sum8d = 0, sumf = 0;
    for (int l = 0; l < num_levels; ++l) {
        if (caps[l] <= 0 || caps[l] > 32767) return -1;  // int16 slot range
        sum8r += (size_t)caps[l] * 8;
        if (l >= 1) {
            sum8d += (size_t)caps[l] * 8;
            sumf += (size_t)caps[l - 1];
        }
    }
    if (sum8r + sum8d > (size_t)1 << 21) return -1;  // 21-bit fixup pos
    // unpacked nibble scratch; packed into the output buffers at the end
    thread_local std::vector<uint8_t> rk_nib, dn_nib, up_nib;
    rk_nib.assign(sum8r, 0);
    dn_nib.assign(sum8d, 0);
    up_nib.assign(sumf, 0);
    int n_fix = 0;
    for (int i = 0; i < fix_cap; ++i) fix[i] = -1;
    auto emit = [&](std::vector<uint8_t>& dst, size_t pos_base, size_t i,
                    int32_t cur, int32_t* prev) -> bool {
        const int32_t d = cur - *prev;
        *prev = cur;
        if (d <= 14) {
            dst[i] = (uint8_t)d;
            return true;
        }
        dst[i] = 15;
        int32_t excess = d - 15;
        const int32_t pos = (int32_t)(pos_base + i);
        while (excess > 0) {
            if (n_fix >= fix_cap) return false;
            const int32_t part = excess > 2047 ? 2047 : excess;
            fix[n_fix++] = (pos << 11) | part;
            excess -= part;
        }
        return true;
    };
    auto pack = [](const std::vector<uint8_t>& v, uint8_t* dst) {
        const size_t nb = (v.size() + 1) / 2;
        for (size_t k = 0; k < nb; ++k) {
            const uint8_t lo = v[2 * k];
            const uint8_t hi = (2 * k + 1 < v.size()) ? v[2 * k + 1] : 0;
            dst[k] = (uint8_t)(lo | (hi << 4));
        }
    };

    thread_local Level cur;
    thread_local std::vector<int32_t> lvl_inverse;
    lvl_inverse.assign((size_t)n, -1);
    voxelize_level(coords, valid, n, caps[0], &cur, inverse, counts);

    size_t off8r = 0, off1 = 0, off8 = 0, offf = 0, offc = 0;
    thread_local std::vector<uint32_t> wbits;  // (cap,) 24 existence bits

    for (int l = 0; l < num_levels; ++l) {
        const int cap = caps[l];
        const int v = cur.num;
        nums[l] = v;

        // Neighbours by one two-pointer co-scan per xy-column (the query
        // stream key + delta of a sorted table is itself sorted), fused with
        // the emission of each column's rank delta and its three dz
        // existence bits. The three dz offsets of a column have consecutive
        // keys, so one scan to the dz=-1 key resolves all three. The centre
        // column (dx = dy = 0) emits only its dz=-1 bit (cbits).
        wbits.assign((size_t)cap, 0);
        std::memset(cbits + offc, 0, (size_t)((cap + 7) / 8));
        {
            const uint64_t* K = cur.keys.data();
            int k = 0;
            for (int dx = -1; dx <= 1; ++dx)
                for (int dy = -1; dy <= 1; ++dy, ++k) {
                    const int64_t dkey = ((int64_t)dx << 24) +
                                         ((int64_t)dy << 12) - 1;  // dz=-1
                    const bool centre = (k == 4);
                    const int cp = k < 4 ? k : k - 1;
                    int32_t prev = 0;
                    int j = 0;
                    for (int i = 0; i < v; ++i) {
                        const uint64_t key = K[i];
                        // signed compare: border queries can go negative
                        const int64_t q = (int64_t)key + dkey;
                        while (j < v && (int64_t)K[j] < q) ++j;
                        const uint32_t x = (uint32_t)(key >> 24);
                        const uint32_t y = (uint32_t)(key >> 12) & 0xFFF;
                        const uint32_t z = (uint32_t)key & 0xFFF;
                        bool s0 = false, s1 = false, s2 = false;
                        int32_t r = prev;
                        if (!((dx < 0 && x == 0) ||
                              (dx > 0 && x == kShift - 1) ||
                              (dy < 0 && y == 0) ||
                              (dy > 0 && y == kShift - 1))) {
                            // sorted unique keys: the q+1 candidate is
                            // j + (hit at q), q+2 likewise. Keys wrap at z
                            // borders, so dz=-1 / dz=+1 are gated by z
                            s0 = j < v && (int64_t)K[j] == q && z != 0;
                            int j1 = j + (int)(j < v && (int64_t)K[j] == q);
                            s1 = j1 < v && (int64_t)K[j1] == q + 1;
                            int j2 = j1 + (int)s1;
                            s2 = j2 < v && (int64_t)K[j2] == q + 2 &&
                                 z != kShift - 1;
                            r = s0 ? j : (s1 ? j1 : (s2 ? j2 : prev));
                        }
                        if (centre) {
                            cbits[offc + i / 8] |= (uint8_t)s0 << (i % 8);
                            continue;
                        }
                        wbits[i] |= ((uint32_t)s0 | ((uint32_t)s1 << 1) |
                                     ((uint32_t)s2 << 2))
                                    << (3 * cp);
                        if (!emit(rk_nib, 0, off8r + (size_t)i * 8 + cp, r,
                                  &prev))
                            return -2;
                    }
                }
            // tail slots [v, cap): no neighbours; every delta nibble stays 0
        }
        for (int i = 0; i < cap; ++i) {
            const uint32_t w = wbits[i];
            ebits[(off1 + i) * 3 + 0] = (uint8_t)(w & 0xFF);
            ebits[(off1 + i) * 3 + 1] = (uint8_t)((w >> 8) & 0xFF);
            ebits[(off1 + i) * 3 + 2] = (uint8_t)((w >> 16) & 0xFF);
        }
        off8r += (size_t)cap * 8;
        off1 += (size_t)cap;
        offc += (size_t)((cap + 7) / 8);

        if (l + 1 < num_levels) {
            // downsample: halve kept coords, sorted-unique dedup
            const int ccap = caps[l + 1];
            thread_local std::vector<int32_t> half;
            thread_local std::vector<uint8_t> hvalid;
            half.assign((size_t)cap * 3, 0);
            hvalid.assign((size_t)cap, 0);
            for (int i = 0; i < v; ++i) {
                half[(size_t)i * 3] = cur.coords[i * 3] >> 1;
                half[(size_t)i * 3 + 1] = cur.coords[i * 3 + 1] >> 1;
                half[(size_t)i * 3 + 2] = cur.coords[i * 3 + 2] >> 1;
                hvalid[i] = 1;
            }
            thread_local Level coarse;
            lvl_inverse.assign((size_t)cap, -1);
            voxelize_level(half.data(), hvalid.data(), cap, ccap, &coarse,
                           lvl_inverse.data(), nullptr);
            const int cv = coarse.num;
            // dense (ccap, 8) child map, then delta-encode per octant column
            thread_local std::vector<int32_t> dn;
            dn.assign((size_t)ccap * 8, -1);
            for (int i = 0; i < cap; ++i) {
                const int32_t c = i < v ? lvl_inverse[i] : -1;
                int o = 0;
                if (i < v)
                    o = ((cur.coords[i * 3] & 1) << 2) |
                        ((cur.coords[i * 3 + 1] & 1) << 1) |
                        (cur.coords[i * 3 + 2] & 1);
                up_nib[offf + i] = (uint8_t)o;
                f2c[offf + i] = (int16_t)c;
                if (c >= 0) dn[(size_t)c * 8 + o] = i;
            }
            {
                int32_t prevd[8] = {0, 0, 0, 0, 0, 0, 0, 0};
                for (int i = 0; i < ccap; ++i) {
                    uint8_t e = 0;
                    for (int o = 0; o < 8; ++o) {
                        const int32_t d =
                            i < cv ? dn[(size_t)i * 8 + o] : -1;
                        e |= (uint8_t)(d >= 0) << o;
                        if (!emit(dn_nib, sum8r, off8 + (size_t)i * 8 + o,
                                  d >= 0 ? d : prevd[o], &prevd[o]))
                            return -2;
                    }
                    downe[off8 / 8 + i] = e;
                }
            }
            off8 += (size_t)ccap * 8;
            offf += (size_t)cap;
            cur = std::move(coarse);
        }
    }
    pack(rk_nib, rankn);
    pack(dn_nib, downn);
    pack(up_nib, upoffn);
    return 0;
}

}  // extern "C"
