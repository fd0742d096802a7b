// Native kernel-map builder: the hot host-side path of the geometry planner.
//
// A copy of openscene_tpu/sparse/csrc/kernel_map.cpp for the PyTorch port,
// which plans on the host where the card does not (the CPU, and a scene
// whose geometry overflows on the card).  Given the (batch,x,y,z) voxel
// coordinates of one level, it builds for every stencil offset the partial
// bijection "output row -> input row" used by the gather-GEMM convolutions,
// and the k=2 s=2 down edge.
//
// Open-addressing hash table (power-of-two, multiplicative hashing, linear
// probing) over packed 64-bit coordinate keys, against the NumPy builder's
// searchsorted probes.  Exposed through a C ABI for ctypes.
//
// Build (sparse/native.py does it at first use, into build/native/):
//   g++ -O3 -march=native -shared -fPIC -o <lib>.so kernel_map.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kFieldBits = 16;
constexpr int64_t kShift = 1 << 14;  // headroom, matches geometry.py

inline uint64_t pack(int32_t b, int32_t x, int32_t y, int32_t z) {
  uint64_t k = (uint64_t)(uint16_t)(b);
  k = (k << kFieldBits) | (uint16_t)(x + kShift);
  k = (k << kFieldBits) | (uint16_t)(y + kShift);
  k = (k << kFieldBits) | (uint16_t)(z + kShift);
  return k;
}

inline uint64_t mix(uint64_t k) {
  // splitmix64 finalizer
  k += 0x9E3779B97F4A7C15ull;
  k = (k ^ (k >> 30)) * 0xBF58476D1CE4E5B9ull;
  k = (k ^ (k >> 27)) * 0x94D049BB133111EBull;
  return k ^ (k >> 31);
}

struct HashTable {
  std::vector<uint64_t> keys;
  std::vector<int32_t> vals;
  uint64_t mask;

  explicit HashTable(int64_t n) {
    int64_t cap = 16;
    while (cap < 2 * n) cap <<= 1;
    keys.assign(cap, ~0ull);
    vals.assign(cap, -1);
    mask = cap - 1;
  }

  inline void insert(uint64_t k, int32_t v) {
    uint64_t i = mix(k) & mask;
    while (keys[i] != ~0ull) i = (i + 1) & mask;
    keys[i] = k;
    vals[i] = v;
  }

  inline int32_t find(uint64_t k) const {
    uint64_t i = mix(k) & mask;
    while (true) {
      if (keys[i] == k) return vals[i];
      if (keys[i] == ~0ull) return -1;
      i = (i + 1) & mask;
    }
  }
};

}  // namespace

extern "C" {

// coords: (n, 4) int32 rows (b, x, y, z); offsets: (K, 3) int32;
// fwd out: (K, cap) int32 pre-filled by the caller with spread-null values;
// writes fwd[k, r] for r < n when the neighbor exists (center offset filled
// with the identity).
void build_self_plan(const int32_t* coords, int64_t n, int64_t cap,
                     const int32_t* offsets, int64_t K, int32_t* fwd) {
  HashTable table(n);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* c = coords + 4 * i;
    table.insert(pack(c[0], c[1], c[2], c[3]), (int32_t)i);
  }
  const int64_t center = K / 2;
  for (int64_t k = 0; k < K; ++k) {
    const int32_t dx = offsets[3 * k], dy = offsets[3 * k + 1],
                  dz = offsets[3 * k + 2];
    int32_t* out = fwd + k * cap;
    if (k == center && dx == 0 && dy == 0 && dz == 0) {
      for (int64_t r = 0; r < n; ++r) out[r] = (int32_t)r;
      continue;
    }
    for (int64_t r = 0; r < n; ++r) {
      const int32_t* c = coords + 4 * r;
      int32_t v = table.find(pack(c[0], c[1] + dx, c[2] + dy, c[3] + dz));
      if (v >= 0) out[r] = v;
    }
  }
}

// Down edge (kernel=2 stride=2): parents = unique floor(child/2) in the
// order of first appearance of the SORTED child array (children are
// lex-sorted, so parents come out lex-sorted too).
// Outputs: parent_coords (cap_parent, 4) untouched beyond n_parent rows,
// child_parent (n,) int32, child_offset (n,) int32, fwd (8, cap_parent)
// pre-filled with spread nulls. Returns n_parent (or -1 on overflow).
int64_t build_down_edge(const int32_t* coords, int64_t n, int64_t cap_parent,
                        int32_t* parent_coords, int32_t* child_parent,
                        int32_t* child_offset, int32_t* fwd) {
  HashTable table(n);
  int64_t n_parent = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* c = coords + 4 * i;
    int32_t px = c[1] >> 1, py = c[2] >> 1, pz = c[3] >> 1;
    // floor division for negatives (coords are >= 0 after voxelizer shift,
    // but the global train shift keeps them non-negative too; >> is fine)
    uint64_t key = pack(c[0], px, py, pz);
    int32_t p = table.find(key);
    if (p < 0) {
      if (n_parent >= cap_parent - 1) return -1;
      p = (int32_t)n_parent++;
      table.insert(key, p);
      int32_t* pc = parent_coords + 4 * p;
      pc[0] = c[0]; pc[1] = px; pc[2] = py; pc[3] = pz;
    }
    int32_t off = ((c[1] & 1) << 2) | ((c[2] & 1) << 1) | (c[3] & 1);
    child_parent[i] = p;
    child_offset[i] = off;
    fwd[(int64_t)off * cap_parent + p] = (int32_t)i;
  }
  return n_parent;
}

}  // extern "C"
