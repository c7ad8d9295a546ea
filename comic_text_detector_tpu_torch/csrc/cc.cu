// Connected-components kernels for Hopper (sm_90a), plain C interface.
//
// Replaces three Pallas TPU kernels of comic_text_detector_tpu/ops/pallas_kernels.py:
//
//   K1 ctd_cc_ids_window  <- _cc_ids_kernel (the fused branch of cc_ids_windows_local)
//      (N, H, W) uint8 mask, H*W <= 512*512 -> int32: every foreground pixel
//      gets its 8-connected component's 1-based id, the rank of the
//      component's root (its minimum window-local linear index) in raster
//      order; background gets 0.
//   K2 ctd_cc_window      <- _cc_window_kernel (cc_windows_local)
//      (N, H, W) uint8 mask -> int32: every foreground pixel gets the
//      minimum window-local linear index (row * W + col) of its
//      8-connected component; background gets 2**30.
//   K3 ctd_min_prop_window <- _min_prop_kernel (min_prop_windows_local)
//      (N, H, W) uint8 mask + int32 seeds -> int32: every foreground pixel
//      gets the minimum seed over its component (the split path marks
//      "no seed" with 2**30); background gets 0.  Seeds on background
//      pixels are not read.
//
// What bounds them.  Labelling does a few integer operations a pixel, so
// all three are bound by memory: K1 and K2 must read the mask and write the
// labels (5 bytes a pixel), K3 must also read the seeds (9 bytes a pixel).
// At the main path's shapes that is 10.5 MB for K1 (32 windows of 256x256,
// 3.1 us at 3.35 TB/s), 21 MB for K2 (4 x 1024x1024, 6.3 us; 4 x 1536x1536,
// 14.1 us) and 37.7 MB for K3 (4 x 1024x1024, 11.3 us).  The TPU
// kernels iterate row/column min-sweeps to a fixpoint with the whole window
// in VMEM; a 1024x1024 int32 window is 4 MB, far beyond the 227 KB of shared
// memory a Hopper block can use, so each window's labels live in device
// memory and the kernels keep as much of the labelling as they can inside
// shared-memory tiles.
//
// All three: block-based union-find (after Allegretti, Bolelli and Grana,
// "Optimized Block-Based Algorithms to Label Connected Components on GPUs",
// IEEE TPDS 2020), four launches each; every launch
// after the first uses programmatic dependent launch (launch_after), which
// hides most of the gaps between them.  A window's pixels are numbered in
// raster order (p = row * W + col); every union hooks the larger root under
// the smaller, so every link points to a smaller index and the root of each
// component is its minimum pixel: K2's label, and the pixel whose raster
// rank is K1's id.
//
//   local    one 256-thread block per tile: up to 8192 pixels, kTilePx / tw
//            rows by tw = min(W, 1024) columns of one window (whole rows
//            wherever W <= 1024: every refine bucket and the DB bitmap at
//            input 1024; tiles of 1024 and 512 columns side by side at 1536).
//            Thread j loads the tile's 32-pixel word j (two 16-byte loads
//            where the tile is one aligned run) and keeps it as a bitmask in
//            shared memory.  Run pieces (a run cut at word and row ends) are
//            the union-find's nodes, so a run of pixels costs one node.  The
//            links are bit operations on whole words: a piece that enters
//            from the previous word unites with it; a pixel unites with N
//            unless W and NW are set, with NW unless N or W is, with NE
//            unless N is (the skipped links are implied by the pixel to the
//            left).  Unions are lock-free, atomicMin hooks in shared memory
//            over the tile-local indices; tile raster order follows window
//            raster order, so each tile root is the minimum of its piece of a
//            component.  The passes over pixels then take one pixel a thread
//            in raster order, so loads and stores coalesce.  The parent array
//            (K2's out) gets one word a pixel: a tile root its own window
//            index, any other foreground pixel ~(its tile root's window
//            index) (< 0), background INT_MIN.  K3 also takes each run piece's minimum seed
//            with a shuffle over the warp (a warp's step is one word) and
//            atomicMins it into its tile root's slot of out: one atomic a
//            piece, inside the block.
//   border   one thread for each pixel with a back-neighbour in another
//            tile: a tile's top row, its left column and, where tiles meet
//            side by side (W > 1024), its right column, whose NE lies in the
//            next tile; 1 in 8 pixels at W = 1024.  It takes the same links
//            under the same rule with the whole mask in view, uniting tile
//            roots through find_root and unite below, which only walk and
//            hook the non-negative links of tile roots.
//   resolve  K2 and K3, four pixels a thread (one 16-byte load): each tile
//            root whose root is another pixel points itself at that root (K2
//            in place in out, its parent array); K3 also atomicMins its tile
//            minimum into the root's slot, so the global atomics number the tile
//            roots, not the pixels.  K1: one 1024-thread block per raster
//            chunk of 8192 pixels of a window (chunks, not tiles, so the rank
//            is right whatever the tiling); each thread takes 8 neighbouring
//            pixels (two 16-byte loads), points each tile root at its root,
//            marks the roots (parent[p] == p, fixed once the border phase is
//            done), and one block scan ranks them; it writes -(rank in the chunk) at each
//            root's slot of out and the chunk's root count to counts.
//   gather   every pixel reaches its root in at most two reads (its own
//            link, then its tile root's).  K2: out[p] = the root, in place,
//            four pixels a thread (one 16-byte load and store); a tile root's
//            slot is rewritten with the root it holds, and any other pixel's
//            slot is read only by its own thread.  K3: out[p] = out[root],
//            four pixels a thread.  K1: each block scans its window's chunk
//            counts (at most 32) and writes ids[p] = rank + the root chunk's offset;
//            a root's own slot may already hold its final (positive) id when
//            another pixel reads it, and both forms give the same id.
//
// K2's traffic is the mask in and links out (local), the links in (resolve),
// the links in and roots out (gather): about 17 bytes a pixel against the 5
// of its bound, besides the finds.  A single in-place pass instead of resolve
// and gather, each pixel walking from its tile root, moves 4 bytes a pixel less
// but was slower on an H100: every thread that meets a tile root walks its
// chain and halves it with atomics (scripts/k2_variants.py times both).
//
// Termination.  A non-root always points to a strictly smaller index, so a
// find walks at most H*W links (the tile's pixel count in shared memory).
// Each retry of a union strictly lowers one of its two operands, so a union
// retries at most twice that.  Every loop carries those counts as bounds;
// exceeding one (impossible unless memory is corrupted) sets *err and the
// Python wrapper raises.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#define CC_BIG (1 << 30)

namespace {

constexpr int kThreads = 256;
constexpr int kTilePx = 8192;        // pixels of a local-phase tile: a 32 KB label array
constexpr int kTileMaxW = 1024;      // widest tile; wider windows get tiles side by side
constexpr int kTileWords = kTilePx / 32;
constexpr int kLocalThreads = kTileWords;  // one thread a 32-pixel word
constexpr int kChunk = 8192;         // K1's rank chunk; ops/cc_kernels.py IDS_CHUNK
constexpr int kChunkThreads = 1024;  // 32 warps: one warp scans the warp totals
constexpr int kMaxChunks = 32;       // 512 * 512 / kChunk: one warp scans the counts
constexpr int kBackground = INT_MIN;

__device__ __forceinline__ int load_link(const int* p) { return __ldcg(p); }

// Root of x, halving the path on the way.  A link only ever moves to a
// smaller index in x's own component, so the atomicMin keeps every link
// valid whatever other threads do meanwhile.
__device__ int find_root(int* parent, int x, int limit, int* err) {
    for (int step = 0; step <= limit; ++step) {
        int p = load_link(parent + x);
        if (p == x) return x;
        int gp = load_link(parent + p);
        if (gp != p) atomicMin(parent + x, gp);
        x = p;
    }
    atomicExch(err, 1);
    return x;
}

__device__ void unite(int* parent, int a, int b, int limit, int* err) {
    for (int step = 0; step <= 2 * limit; ++step) {
        a = find_root(parent, a, limit, err);
        b = find_root(parent, b, limit, err);
        if (a == b) return;
        if (a < b) {
            int t = a;
            a = b;
            b = t;
        }
        // a > b: hook a under b.  If a was hooked elsewhere meanwhile, the
        // link a -> old survives as a -> min(old, b), and old must still be
        // united with b.
        int old = atomicMin(parent + a, b);
        if (old == a) return;
        a = old;
    }
    atomicExch(err, 1);
}

// The later launches of K1, K2 and K3 use programmatic dependent launch: a
// kernel may start while the previous one in the stream drains, and waits
// for that kernel's results (griddep_wait, its first statement) before it
// reads them.  That hides most of the gap between the dependent launches.
template <typename... Params, typename... Args>
cudaError_t launch_after(void (*kernel)(Params...), dim3 grid, dim3 block, cudaStream_t stream, Args... args) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

__device__ __forceinline__ void griddep_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

inline unsigned int blocks_for(long long total) {
    return (unsigned int)((total + kThreads - 1) / kThreads);
}

// ---------------------------------------------------------------------------
// K1, K2 and K3: tiles
// ---------------------------------------------------------------------------

struct Tiling {
    int tw, rows, across, tiles;  // tile width and rows; tiles across a window, tiles a window
};

Tiling tiling(int h, int w) {
    Tiling t;
    t.tw = w < kTileMaxW ? w : kTileMaxW;
    t.rows = kTilePx / t.tw;
    t.across = (w + t.tw - 1) / t.tw;
    t.tiles = t.across * ((h + t.rows - 1) / t.rows);
    return t;
}

struct Tile {
    long long base;      // the window's first pixel
    int y0, x0, rows, tw;  // the tile's first row and column, its rows and width
};

__device__ Tile tile_of(const Tiling& t, int h, int w) {
    Tile s;
    int n = blockIdx.x / t.tiles, k = blockIdx.x - n * t.tiles;
    int ty = k / t.across, tx = k - ty * t.across;
    s.base = (long long)n * h * w;
    s.y0 = ty * t.rows;
    s.x0 = tx * t.tw;
    s.rows = min(t.rows, h - s.y0);
    s.tw = min(t.tw, w - s.x0);
    return s;
}

// find_root and unite over a tile's labels in shared memory
__device__ int find_shared(int* lab, int x, int limit, int* err) {
    volatile int* v = lab;
    for (int step = 0; step <= limit; ++step) {
        int p = v[x];
        if (p == x) return x;
        int gp = v[p];
        if (gp != p) atomicMin(lab + x, gp);
        x = p;
    }
    atomicExch(err, 1);
    return x;
}

// Walks a and b to their roots together (two independent loads a step),
// then hooks the larger root under the smaller, as unite does.  Last, the
// two starting nodes point straight at the merged root (an atomicMin, so a
// hook made meanwhile is never undone), which keeps later walks short.
__device__ void unite_shared(int* lab, int a, int b, int limit, int* err) {
    volatile int* v = lab;
    const int a0 = a, b0 = b;
    for (int step = 0; step <= 2 * limit; ++step) {
        for (int walk = 0; walk <= limit; ++walk) {
            int pa = v[a], pb = v[b];
            if (pa == a && pb == b) break;
            a = pa;
            b = pb;
            if (walk == limit) atomicExch(err, 1);
        }
        if (a < b) {
            int t = a;
            a = b;
            b = t;
        }
        // a >= b: b is the merged root (a == b: already one tree).  If a was
        // hooked elsewhere meanwhile, the link a -> old survives as
        // a -> min(old, b), and old must still be united with b.
        int old = a == b ? a : atomicMin(lab + a, b);
        if (old == a) {
            if (a0 != b) atomicMin(lab + a0, b);
            if (b0 != b) atomicMin(lab + b0, b);
            return;
        }
        a = old;
    }
    atomicExch(err, 1);
}

// Foreground bits of the 32 tile pixels from tile index start on (bit k is
// pixel start + k); pixels before the tile read as background.  bits has a
// zero word after the tile's last.
__device__ __forceinline__ uint32_t bits_at(const uint32_t* bits, int start) {
    if (start <= -32) return 0;
    if (start < 0) return bits[0] << -start;
    return __funnelshift_r(bits[start >> 5], bits[(start >> 5) + 1], start & 31);
}

// The start of the run piece holding foreground tile pixel q, whose word's
// piece starts are word_starts: the highest start at or below q's bit (bit
// 0 of a word is a piece start wherever it is foreground).
__device__ __forceinline__ int piece_start(uint32_t word_starts, int q) {
    return (q & ~31) + 31 - __clz(word_starts & (0xffffffffu >> (31 - (q & 31))));
}

// Nonzero bytes of v as 4 bits: a byte's top bit after the add is set iff
// the byte is nonzero, and the multiply moves the four top bits to 28..31
// with no carries between them.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t v) {
    uint32_t top = (v | ((v & 0x7f7f7f7fu) + 0x7f7f7f7fu)) & 0x80808080u;
    return (top * 0x00204081u) >> 28;
}

// (y, x) of tile pixel i, stepped by kLocalThreads without a division
struct Walk {
    int y, x, dy, dx, tw;
    __device__ Walk(int i, int tw_) : tw(tw_) {
        y = i / tw;
        x = i - y * tw;
        dy = kLocalThreads / tw;
        dx = kLocalThreads - dy * tw;
    }
    __device__ void step() {
        y += dy;
        x += dx;
        if (x >= tw) {
            x -= tw;
            ++y;
        }
    }
};

// The local phase.  For the unions, thread j owns the tile's 32-pixel word
// j (tile pixels 32j .. 32j + 31 in tile raster order; a word may span
// rows); the passes over pixels take one pixel a thread in raster order,
// so that their loads and stores coalesce.  With kSeeds (K3), also writes
// each tile root's minimum seed at its slot of out.
template <bool kSeeds>
__global__ void __launch_bounds__(kLocalThreads)
local_kernel(const uint8_t* __restrict__ mask, const int* __restrict__ seeds, int* __restrict__ parent,
             int* __restrict__ out, int h, int w, Tiling t, int* err) {
    __shared__ int lab[kTilePx];                // union-find over the piece starts
    __shared__ uint32_t bits[kTileWords + 1];   // foreground, and a zero word after the tile
    __shared__ uint32_t starts[kTileWords];     // piece starts
    const Tile s = tile_of(t, h, w);
    const int npx = s.rows * s.tw;
    const long long first = s.base + (long long)s.y0 * w + s.x0;  // the tile's first pixel; row stride w
    const int p0 = s.y0 * w + s.x0;                                // its window index
    const bool whole_rows = s.tw == w;                             // the tile is one contiguous run
    const int j = threadIdx.x, i0 = 32 * j;
    const int left = npx - i0;  // tile pixels from the word's first on
    const uint8_t* m = mask + first;

    // Foreground bits.  The word holds min(32, left) pixels of the tile; the
    // branches test left >= 32 and left > 0 themselves: with the count
    // clamped by max(0, min(32, left)) and tested == 32, the sm_90a build
    // of nvcc 12.9 loaded a full word for the word just past the tile's end.
    uint32_t fg = 0;
    if (left >= 32 && whole_rows && ((uintptr_t)(m + i0) & 15) == 0) {
        const uint4* m16 = reinterpret_cast<const uint4*>(m + i0);
        uint4 a = m16[0], b = m16[1];
        fg = nonzero_bytes(a.x) | nonzero_bytes(a.y) << 4 | nonzero_bytes(a.z) << 8 | nonzero_bytes(a.w) << 12 |
             nonzero_bytes(b.x) << 16 | nonzero_bytes(b.y) << 20 | nonzero_bytes(b.z) << 24 |
             nonzero_bytes(b.w) << 28;
    } else if (left > 0) {
        Walk at(i0, s.tw);
        for (int k = 0; k < 32 && k < left; ++k) {
            if (m[(long long)at.y * w + at.x]) fg |= 1u << k;
            if (++at.x == s.tw) {
                at.x = 0;
                ++at.y;
            }
        }
    }
    bits[j] = fg;
    if (j == 0) bits[kTileWords] = 0;
    __syncthreads();

    // row starts in the word (x == 0) and last columns (x == tw - 1)
    const int cx = i0 % s.tw;
    uint32_t row_start = 0;
    for (int k = cx == 0 ? 0 : s.tw - cx; k < 32; k += s.tw) row_start |= 1u << k;
    const uint32_t last_col = row_start >> 1 | ((cx + 32) % s.tw == 0 ? 1u << 31 : 0u);
    const uint32_t west = (fg << 1 | (j > 0 ? bits[j - 1] >> 31 : 0u)) & ~row_start;
    const uint32_t my_starts = fg & (~west | 1u);
    starts[j] = my_starts;
    for (uint32_t e = my_starts; e; e &= e - 1) lab[i0 + __ffs(e) - 1] = i0 + __ffs(e) - 1;
    __syncthreads();

    // Unions, one for each link the pixel to the left does not imply: W where
    // a run enters the word; N unless W and NW are set, NW unless N or W is,
    // NE unless N is.  Pixels outside the tile read as background, so a
    // skipped link is always implied inside the tile.  The links are taken
    // in raster order through one call site, so that the lanes of a warp
    // walk their unions together.
    {
        const uint32_t north = bits_at(bits, i0 - s.tw);
        const uint32_t nw = bits_at(bits, i0 - s.tw - 1) & ~row_start;
        const uint32_t ne = bits_at(bits, i0 - s.tw + 1) & ~last_col;
        uint32_t link_w = fg & west & 1u;
        uint32_t link_n = fg & north & ~(west & nw);
        uint32_t link_nw = fg & nw & ~north & ~west;
        uint32_t link_ne = fg & ne & ~north;
        while (link_w | link_n | link_nw | link_ne) {
            uint32_t* links;  // the kind of link taken next, and where its other end lies
            int back;
            uint32_t up = link_n | link_nw | link_ne;
            uint32_t next = up & (0u - up);  // the lowest pixel with a link upwards
            if (link_w) {
                links = &link_w, back = 1;
            } else if (link_n & next) {
                links = &link_n, back = s.tw;
            } else if (link_nw & next) {
                links = &link_nw, back = s.tw + 1;
            } else {
                links = &link_ne, back = s.tw - 1;
            }
            int k = __ffs(*links) - 1;
            *links &= *links - 1;
            int q = i0 + k - back;
            unite_shared(lab, piece_start(my_starts, i0 + k), piece_start(starts[q >> 5], q), npx, err);
        }
    }
    __syncthreads();

    // A root's row is (root + 0.5) / tw rounded down, exact in float: the
    // quotient is at most 8192 / tw and lies at least 0.5 / tw from an integer.
    const float inv_tw = 1.0f / s.tw;
    auto window_index = [&](int r) {
        int ry = (int)((r + 0.5f) * inv_tw);
        return p0 + ry * w + (r - ry * s.tw);
    };

    // every piece start points at its root (writing a root, an ancestor,
    // while others still walk through the start is safe); K3 readies each
    // root's slot of out for the minimum
    for (uint32_t e = my_starts; e; e &= e - 1) {
        int i = i0 + __ffs(e) - 1;
        int r = find_shared(lab, i, npx, err);
        lab[i] = r;
        if (kSeeds && r == i) out[s.base + window_index(r)] = INT_MAX;
    }
    __syncthreads();

    if (kSeeds) {
        // Each root's minimum seed.  A warp's step covers one word, lane k
        // its pixel k, so a shuffle min over each run piece (bounded by the
        // piece's last pixel) leaves the piece's minimum at its start, which
        // takes one atomic into its root's slot of out (inside this block's
        // tile, so the barrier below orders it before the slot is read).
        const int lane = threadIdx.x & 31;
        Walk at(threadIdx.x, s.tw);
        for (int i = threadIdx.x; i - lane < npx; i += kLocalThreads, at.step()) {
            const uint32_t word = bits[i >> 5], st = starts[i >> 5];
            const bool on = i < npx && (word >> lane & 1u);
            int lowest = on ? seeds[first + (long long)at.y * w + at.x] : INT_MAX;
            const uint32_t stop = (~word | st) & ~(0xffffffffu >> (31 - lane));  // ends of pieces after lane
            const int last = stop ? __ffs(stop) - 2 : 31;                          // the piece's last lane
            for (int d = 1; d < 32; d <<= 1) {
                int other = __shfl_down_sync(0xffffffffu, lowest, d);
                if (lane + d <= last) lowest = min(lowest, other);
            }
            if (on && (st >> lane & 1u)) atomicMin(out + s.base + window_index(lab[i]), lowest);
        }
        __syncthreads();
    }

    Walk at(threadIdx.x, s.tw);
    for (int i = threadIdx.x; i < npx; i += kLocalThreads, at.step()) {
        int link = kBackground;
        if (bits[i >> 5] >> (i & 31) & 1u) {
            int r = lab[piece_start(starts[i >> 5], i)];
            link = r == i ? window_index(r) : ~window_index(r);
        }
        parent[first + (long long)at.y * w + at.x] = link;
    }
}

// The tile root of foreground pixel x
__device__ __forceinline__ int tile_root(const int* par, int x) {
    int v = load_link(par + x);
    return v < 0 ? ~v : x;
}

// Unites pixel (y, x) with each back-neighbour in another tile, under the
// local phase's rule with the whole mask in view: a skipped link is implied
// by links that some pixel takes.
__device__ void border_links(const uint8_t* m, int* par, int y, int x, const Tile& s, int w, int hw,
                             int* err) {
    int p = y * w + x;
    if (!m[p]) return;
    bool west = x > 0 && m[p - 1];
    if (west && x == s.x0) unite(par, tile_root(par, p), tile_root(par, p - 1), hw, err);
    if (y == 0) return;
    int q = p - w;
    bool above = y == s.y0;  // the row above lies in other tiles
    bool nw = x > 0 && m[q - 1];
    if (m[q]) {
        if (above && !(west && nw)) unite(par, tile_root(par, p), tile_root(par, q), hw, err);
        return;
    }
    if (nw && !west && (above || x == s.x0)) unite(par, tile_root(par, p), tile_root(par, q - 1), hw, err);
    if (x + 1 < w && m[q + 1] && (above || x + 1 == s.x0 + s.tw))
        unite(par, tile_root(par, p), tile_root(par, q + 1), hw, err);
}

// One thread a slot: blockIdx.y * blockDim.x + threadIdx.x counts the slots
// of tile blockIdx.x.
__global__ void border_kernel(const uint8_t* __restrict__ mask, int* parent, int h, int w, Tiling t,
                              int* err) {
    griddep_wait();
    const Tile s = tile_of(t, h, w);
    int first = s.y0 > 0 ? 1 : 0;                  // the side columns' first row below the top row
    int top = s.y0 > 0 ? s.tw : 0;                 // N, NW, NE lie in the tiles above
    int left = s.x0 > 0 ? s.rows - first : 0;      // W, NW lie in the tile to the left
    int right = s.x0 + s.tw < w ? s.rows - 1 : 0;  // NE lies in the tile to the right
    int k = blockIdx.y * blockDim.x + threadIdx.x;
    if (k >= top + left + right) return;
    int y, x;
    if (k < top) {
        y = s.y0;
        x = s.x0 + k;
    } else if (k < top + left) {
        y = s.y0 + first + (k - top);
        x = s.x0;
    } else {
        y = s.y0 + 1 + (k - top - left);
        x = s.x0 + s.tw - 1;
    }
    border_links(mask + s.base, parent + s.base, y, x, s, w, h * w, err);
}

// The border kernel's grid: a tile's slots are at most its width and two columns
dim3 border_grid(const Tiling& t, int n) {
    return dim3((unsigned int)(n * (long long)t.tiles), (t.tw + 2 * t.rows + kThreads - 1) / kThreads);
}

// ---------------------------------------------------------------------------
// K2 and K3: resolve and gather, four pixels a thread
// ---------------------------------------------------------------------------

// The four pixels from i0 on into v: one 16-byte load where all four lie in
// the array (the wrappers start every array on 16 bytes), background past
// its end.  Returns whether the one load was taken.
__device__ __forceinline__ bool load_quad(const int* a, long long i0, long long total, int v[4]) {
    if (i0 + 4 <= total) {
        int4 q = *reinterpret_cast<const int4*>(a + i0);
        v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
        return true;
    }
    for (int k = 0; k < 4; ++k) v[k] = i0 + k < total ? a[i0 + k] : kBackground;
    return false;
}

__device__ __forceinline__ void store_quad(int* a, long long i0, long long total, bool whole, const int r[4]) {
    if (whole) {
        *reinterpret_cast<int4*>(a + i0) = make_int4(r[0], r[1], r[2], r[3]);
    } else {
        for (int k = 0; k < 4 && i0 + k < total; ++k) a[i0 + k] = r[k];
    }
}

// Each tile root that is not its component's root points at the root.  K3
// (kMin) also takes its tile minimum into the root's slot of out: a tile
// root's slot of out is only read here, the root's only written, so the two
// never race.
template <bool kMin>
__global__ void resolve_kernel(int* parent, int* out, long long total, int hw, int* err) {
    griddep_wait();
    long long i0 = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
    if (i0 >= total) return;
    int v[4];
    load_quad(parent, i0, total, v);
    for (int k = 0; k < 4; ++k) {
        if (v[k] < 0) continue;  // background, or not a tile root
        long long i = i0 + k, base = i - i % hw;
        int p = (int)(i - base);
        int g = find_root(parent + base, p, hw, err);
        if (g == p) continue;
        if (kMin) atomicMin(out + base + g, out[i]);
        parent[i] = g;
    }
}

// After the resolve every tile root points at its root, so each foreground
// pixel reaches it in at most two reads.  K2 (kRoots, in place: out is the
// parent array) writes the root, 2**30 on the background; K3 the value of
// the root's slot of out (the component's minimum), 0 on the background.
// Either way a slot that other threads read is rewritten with the value it
// holds, so those reads never race.
template <bool kRoots>
__global__ void gather_kernel(const int* parent, int* out, long long total, int hw) {
    griddep_wait();
    long long i0 = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
    if (i0 >= total) return;
    int v[4], r[4];
    bool whole = load_quad(parent, i0, total, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        r[k] = kRoots ? CC_BIG : 0;
        if (v[k] == kBackground) continue;
        long long base = (i0 + k) - (i0 + k) % hw;
        int g = v[k] >= 0 ? v[k] : parent[base + ~v[k]];
        r[k] = kRoots ? g : out[base + g];
    }
    store_quad(out, i0, total, whole, r);
}

// ---------------------------------------------------------------------------
// K1: rank and gather over raster chunks
// ---------------------------------------------------------------------------

// Each thread takes kChunk / kChunkThreads neighbouring pixels of the chunk:
// their loads are all in flight together, and one block scan ranks the
// roots in raster order.
constexpr int kChunkRun = kChunk / kChunkThreads;

__global__ void __launch_bounds__(kChunkThreads)
rank_chunks_kernel(int* parent, int* out, int* counts, int hw, int chunks, int* err) {
    griddep_wait();
    __shared__ int warp_sum[kChunkThreads / 32];
    int n = blockIdx.x / chunks, c = blockIdx.x - n * chunks;
    long long base = (long long)n * hw;
    int* par = parent + base;
    int lo = c * kChunk + kChunkRun * threadIdx.x, hi = min(c * kChunk + kChunk, hw);
    int v[kChunkRun];
    if (lo + kChunkRun <= hi && ((uintptr_t)(par + lo) & 15) == 0) {
        int4 a = *reinterpret_cast<const int4*>(par + lo), b = *reinterpret_cast<const int4*>(par + lo + 4);
        v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    } else {
#pragma unroll
        for (int k = 0; k < kChunkRun; ++k) v[k] = lo + k < hi ? par[lo + k] : kBackground;
    }
    unsigned roots = 0;  // bit k: pixel lo + k is its component's root
#pragma unroll
    for (int k = 0; k < kChunkRun; ++k) {
        if (v[k] < 0) continue;  // background, or not a tile root
        int g = find_root(par, lo + k, hw, err);
        if (g == lo + k) roots |= 1u << k;
        else par[lo + k] = g;
    }
    int count = __popc(roots);
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = count;
    for (int d = 1; d < 32; d <<= 1) {
        int x = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += x;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int x = warp_sum[lane];
        for (int d = 1; d < 32; d <<= 1) {
            int y = __shfl_up_sync(0xffffffffu, x, d);
            if (lane >= d) x += y;
        }
        warp_sum[lane] = x;
    }
    __syncthreads();
    int rank = incl - count + (warp > 0 ? warp_sum[warp - 1] : 0);
    for (unsigned e = roots; e; e &= e - 1) out[base + lo + __ffs(e) - 1] = -(++rank);
    if (threadIdx.x == 0) counts[(long long)n * chunks + c] = warp_sum[31];
}

__global__ void __launch_bounds__(kChunkThreads)
ids_gather_kernel(const int* __restrict__ parent, const int* __restrict__ counts, int* out, int hw,
                  int chunks) {
    griddep_wait();
    __shared__ int offset[kMaxChunks];
    int n = blockIdx.x / chunks, c = blockIdx.x - n * chunks;
    long long base = (long long)n * hw;
    const int* par = parent + base;
    int* o = out + base;
    if (threadIdx.x < 32) {
        int lane = threadIdx.x;
        int cnt = lane < chunks ? counts[(long long)n * chunks + lane] : 0;
        int s = cnt;
        for (int d = 1; d < 32; d <<= 1) {
            int x = __shfl_up_sync(0xffffffffu, s, d);
            if (lane >= d) s += x;
        }
        offset[lane] = s - cnt;
    }
    __syncthreads();
    // lane-neighbouring pixels, all loads in flight together
    int lo = c * kChunk + threadIdx.x, hi = min(c * kChunk + kChunk, hw);
    int v[kChunkRun];
#pragma unroll
    for (int k = 0; k < kChunkRun; ++k) {
        int p = lo + k * kChunkThreads;
        v[k] = p < hi ? par[p] : kBackground;
    }
#pragma unroll
    for (int k = 0; k < kChunkRun; ++k) {
        int p = lo + k * kChunkThreads;
        if (p >= hi) break;
        int id = 0;
        if (v[k] != kBackground) {
            int g = v[k] >= 0 ? v[k] : par[~v[k]];
            int r = __ldcg(o + g);  // -(rank in its chunk), or already the root's id
            id = r < 0 ? offset[g / kChunk] - r : r;
        }
        o[p] = id;
    }
}

}  // namespace

extern "C" {

// K2.  out doubles as the parent array and starts on 16 bytes.  Returns
// cudaGetLastError().
int ctd_cc_window(const uint8_t* mask, int32_t* out, int32_t* err, int n, int h, int w,
                  cudaStream_t stream) {
    long long total = (long long)n * h * w;
    if (total == 0) return (int)cudaGetLastError();
    Tiling t = tiling(h, w);
    unsigned int tiles = (unsigned int)(n * (long long)t.tiles);
    local_kernel<false><<<tiles, kLocalThreads, 0, stream>>>(mask, nullptr, out, nullptr, h, w, t, err);
    unsigned int quads = blocks_for((total + 3) / 4);  // four pixels a thread
    cudaError_t rc = launch_after(border_kernel, border_grid(t, n), dim3(kThreads), stream, mask, out, h, w, t, err);
    if (rc == cudaSuccess)
        rc = launch_after(resolve_kernel<false>, dim3(quads), dim3(kThreads), stream, out, (int*)nullptr, total,
                          h * w, err);
    if (rc == cudaSuccess)
        rc = launch_after(gather_kernel<true>, dim3(quads), dim3(kThreads), stream, (const int*)out, out, total, h * w);
    return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

// K3.  parent is int32 scratch of the same shape.  Returns cudaGetLastError().
int ctd_min_prop_window(const uint8_t* mask, const int32_t* seeds, int32_t* parent, int32_t* out,
                        int32_t* err, int n, int h, int w, cudaStream_t stream) {
    long long total = (long long)n * h * w;
    if (total == 0) return (int)cudaGetLastError();
    Tiling t = tiling(h, w);
    unsigned int tiles = (unsigned int)(n * (long long)t.tiles);
    local_kernel<true><<<tiles, kLocalThreads, 0, stream>>>(mask, seeds, parent, out, h, w, t, err);
    unsigned int quads = blocks_for((total + 3) / 4);  // four pixels a thread
    cudaError_t rc = launch_after(border_kernel, border_grid(t, n), dim3(kThreads), stream, mask, parent, h, w, t, err);
    if (rc == cudaSuccess)
        rc = launch_after(resolve_kernel<true>, dim3(quads), dim3(kThreads), stream, parent, out, total, h * w, err);
    if (rc == cudaSuccess)
        rc = launch_after(gather_kernel<false>, dim3(quads), dim3(kThreads), stream, (const int*)parent, out, total,
                          h * w);
    return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

// K1.  parent is int32 scratch of the same shape, counts int32 scratch of
// n * ceil(h * w / 8192) (at most 32 a window).  Returns cudaGetLastError().
int ctd_cc_ids_window(const uint8_t* mask, int32_t* parent, int32_t* counts, int32_t* out, int32_t* err,
                      int n, int h, int w, cudaStream_t stream) {
    long long total = (long long)n * h * w;
    if (total == 0) return (int)cudaGetLastError();
    int chunks = (h * w + kChunk - 1) / kChunk;
    if (chunks > kMaxChunks) return (int)cudaErrorInvalidValue;
    Tiling t = tiling(h, w);
    unsigned int tiles = (unsigned int)(n * (long long)t.tiles);
    local_kernel<false><<<tiles, kLocalThreads, 0, stream>>>(mask, nullptr, parent, nullptr, h, w, t, err);
    dim3 blocks(n * chunks);
    cudaError_t rc = launch_after(border_kernel, border_grid(t, n), dim3(kThreads), stream, mask, parent, h, w, t, err);
    if (rc == cudaSuccess)
        rc = launch_after(rank_chunks_kernel, blocks, dim3(kChunkThreads), stream, parent, out, counts, h * w, chunks, err);
    if (rc == cudaSuccess)
        rc = launch_after(ids_gather_kernel, blocks, dim3(kChunkThreads), stream, (const int*)parent,
                          (const int*)counts, out, h * w, chunks);
    return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

const char* ctd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
