// Native host-side runtime components for flatnav_tpu_torch.
//
// The device compute path (distances, beam search, construction waves) lives
// in PyTorch and the CUDA kernels beside this file; the host-side runtime
// pieces that the reference implements in C++ are C++ here too, exposed
// through a C ABI for ctypes. The code below this comment is the same as
// flatnav_tpu/native/flatnav_native.cpp.
//
//   * Gorder / Reverse-Cuthill-McKee graph reordering: the analog of the
//     reference's include/flatnav/util/Reordering.h and
//     GorderPriorityQueue.h. These are irregular pointer-chasing passes
//     that run offline on the host, far too slow in Python at the 1M-node
//     scale of the reference's benchmarks.
//   * MatrixMarket (.mtx) edge-list parsing for the HNSW-base-layer import
//     path (Index::buildGraphLinks, Index.h:187-238).
//   * .npy (v1.0) read/write for the CLI tools: the role cnpy plays for
//     the reference's tools.
//
// All graph inputs use the dense [n, m] int32 links layout with self-loop
// padding (links[i*m+j] == i means "unused slot"), matching
// flatnav_tpu_torch.index.graph.
//
// Build: flatnav_tpu_torch/_build.py compiles this file with the host
// compiler (g++ -std=c++17 -O3 -fPIC -shared) at first use.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Gorder priority queue: array kept ascending by priority; increment and
// decrement are O(1) swaps with the boundary element of the node's priority
// class; pop takes the max from the tail. (Fresh implementation of the
// classic Gorder structure; role matches GorderPriorityQueue.h:13-109.)
// ---------------------------------------------------------------------------
namespace {

class GorderQueue {
 public:
  explicit GorderQueue(int64_t n)
      : arr_(n), pos_(n), prio_(n, 0), popped_(n, 0), size_(n) {
    for (int64_t i = 0; i < n; i++) {
      arr_[i] = i;
      pos_[i] = i;
    }
    first_[0] = 0;
    last_[0] = n - 1;
  }

  void increment(int64_t u) {
    if (popped_[u]) return;
    int64_t p = prio_[u];
    int64_t i = pos_[u];
    int64_t e = last_.at(p);
    swap_at(i, e);
    shrink_class_right(p, e);
    prio_[u] = p + 1;
    auto it = first_.find(p + 1);
    if (it == first_.end()) {
      first_[p + 1] = e;
      last_[p + 1] = e;
    } else {
      it->second = e;  // class p+1 now starts one earlier
    }
  }

  void decrement(int64_t u) {
    if (popped_[u]) return;
    int64_t p = prio_[u];
    int64_t i = pos_[u];
    int64_t s = first_.at(p);
    swap_at(i, s);
    shrink_class_left(p, s);
    prio_[u] = p - 1;
    auto it = last_.find(p - 1);
    if (it == last_.end()) {
      first_[p - 1] = s;
      last_[p - 1] = s;
    } else {
      it->second = s;  // class p-1 now ends one later
    }
  }

  int64_t pop() {
    int64_t u = arr_[size_ - 1];
    int64_t p = prio_[u];
    shrink_class_right(p, size_ - 1);
    popped_[u] = 1;
    size_--;
    return u;
  }

  bool empty() const { return size_ == 0; }

 private:
  void swap_at(int64_t i, int64_t j) {
    int64_t a = arr_[i], b = arr_[j];
    std::swap(arr_[i], arr_[j]);
    pos_[a] = j;
    pos_[b] = i;
  }
  void shrink_class_right(int64_t p, int64_t e) {
    if (first_.at(p) > e - 1) {
      first_.erase(p);
      last_.erase(p);
    } else {
      last_[p] = e - 1;
    }
  }
  void shrink_class_left(int64_t p, int64_t s) {
    if (last_.at(p) < s + 1) {
      first_.erase(p);
      last_.erase(p);
    } else {
      first_[p] = s + 1;
    }
  }

  std::vector<int64_t> arr_, pos_, prio_;
  std::vector<uint8_t> popped_;
  std::unordered_map<int64_t, int64_t> first_, last_;
  int64_t size_;
};

void build_adjacency(const int32_t* links, int64_t n, int64_t m,
                     std::vector<std::vector<int32_t>>& out,
                     std::vector<std::vector<int32_t>>* in) {
  out.assign(n, {});
  if (in) in->assign(n, {});
  for (int64_t i = 0; i < n; i++) {
    for (int64_t j = 0; j < m; j++) {
      int32_t e = links[i * m + j];
      if (e != (int32_t)i && e >= 0 && e < n) {
        out[i].push_back(e);
        if (in) (*in)[e].push_back((int32_t)i);
      }
    }
  }
}

}  // namespace

// Gorder sliding-window greedy ordering. perm_out[i] = new id of node i.
// Semantics mirror Reordering.h:26-117 (seed node 0; out-, in-, and
// in-out-neighbor increments over a window of size w).
int fn_gorder(const int32_t* links, int64_t n, int64_t m, int64_t window,
              int32_t* perm_out) {
  std::vector<std::vector<int32_t>> out_t, in_t;
  build_adjacency(links, n, m, out_t, &in_t);

  GorderQueue q(n);
  std::vector<int64_t> order(n);
  q.increment(0);
  order[0] = q.pop();

  for (int64_t i = 1; i < n; i++) {
    int64_t ve = order[i - 1];
    for (int32_t u : out_t[ve]) q.increment(u);
    for (int32_t u : in_t[ve]) {
      q.increment(u);
      for (int32_t v : out_t[u]) q.increment(v);
    }
    if (i > window + 1) {
      int64_t vb = order[i - window - 1];
      for (int32_t u : out_t[vb]) q.decrement(u);
      for (int32_t u : in_t[vb]) {
        q.decrement(u);
        for (int32_t v : out_t[u]) q.decrement(v);
      }
    }
    order[i] = q.pop();
  }
  for (int64_t i = 0; i < n; i++) perm_out[order[i]] = (int32_t)i;
  return 0;
}

// Reverse Cuthill-McKee. Semantics mirror Reordering.h:119-200: BFS from
// min-degree roots, neighbors enqueued min-degree-first, order reversed.
int fn_rcm(const int32_t* links, int64_t n, int64_t m, int32_t* perm_out) {
  std::vector<std::vector<int32_t>> out_t;
  build_adjacency(links, n, m, out_t, nullptr);
  std::vector<int32_t> degree(n);
  std::vector<int64_t> roots(n);
  for (int64_t i = 0; i < n; i++) {
    degree[i] = (int32_t)out_t[i].size();
    roots[i] = i;
  }
  std::stable_sort(roots.begin(), roots.end(),
                   [&](int64_t a, int64_t b) { return degree[a] < degree[b]; });

  std::vector<uint8_t> visited(n, 0);
  std::vector<int64_t> order;
  order.reserve(n);
  auto by_degree = [&](int32_t a, int32_t b) { return degree[a] < degree[b]; };

  std::vector<int32_t> nbrs;
  for (int64_t root : roots) {
    if (visited[root]) continue;
    visited[root] = 1;
    order.push_back(root);
    std::queue<int32_t> bfs;
    nbrs = out_t[root];
    std::stable_sort(nbrs.begin(), nbrs.end(), by_degree);
    for (int32_t u : nbrs) bfs.push(u);
    while (!bfs.empty()) {
      int32_t cand = bfs.front();
      bfs.pop();
      if (visited[cand]) continue;
      visited[cand] = 1;
      order.push_back(cand);
      nbrs = out_t[cand];
      std::stable_sort(nbrs.begin(), nbrs.end(), by_degree);
      for (int32_t u : nbrs) bfs.push(u);
    }
  }
  std::reverse(order.begin(), order.end());
  for (int64_t i = 0; i < n; i++) perm_out[order[i]] = (int32_t)i;
  return 0;
}

// MatrixMarket edge list -> dense links with self-loop padding.
// Mirrors Index::buildGraphLinks parsing (Index.h:187-238): 1-indexed
// "src dst" rows; at most m edges kept per source. Returns number of edges
// applied, or -1 on error.
int64_t fn_read_mtx(const char* path, int64_t n, int64_t m,
                    int32_t* links_out) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  char line[512];
  if (!fgets(line, sizeof line, f) ||
      strncmp(line, "%%MatrixMarket", 14) != 0) {
    fclose(f);
    return -1;
  }
  do {
    if (!fgets(line, sizeof line, f)) {
      fclose(f);
      return -1;
    }
  } while (line[0] == '%');
  long long rows, cols, entries;
  if (sscanf(line, "%lld %lld %lld", &rows, &cols, &entries) != 3 ||
      rows != n || cols != n) {
    fclose(f);
    return -1;
  }
  for (int64_t i = 0; i < n; i++)
    for (int64_t j = 0; j < m; j++) links_out[i * m + j] = (int32_t)i;
  std::vector<int32_t> count(n, 0);
  int64_t applied = 0;
  long long a, b;
  while (fscanf(f, "%lld %lld", &a, &b) == 2) {
    // tolerate an optional weight column (and CRLF line endings: a '\r'
    // left in the stream would otherwise be ungetc'd and make the %lf
    // probe consume the NEXT edge's source id as a weight)
    int c = fgetc(f);
    while (c == ' ' || c == '\t' || c == '\r') c = fgetc(f);
    if (c != '\n' && c != EOF) {
      ungetc(c, f);
      double w;
      if (fscanf(f, "%lf", &w) != 1) break;
    } else if (c == '\n') {
      // done with row
    }
    int64_t src = a - 1, dst = b - 1;
    if (src < 0 || src >= n || dst < 0 || dst >= n) continue;
    if (count[src] < m) {
      links_out[src * m + count[src]] = (int32_t)dst;
      count[src]++;
      applied++;
    }
  }
  fclose(f);
  return applied;
}

// ---------------------------------------------------------------------------
// Minimal .npy v1.0 IO (float32/uint8/int8/int32 2-D arrays) — the role of
// cnpy in the reference tools (tools/construct_npy.cpp uses cnpy::npy_load).
// ---------------------------------------------------------------------------
int fn_npy_header(const char* path, int64_t* n_out, int64_t* d_out,
                  char* dtype_out /* >= 8 bytes */) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8 || magic[0] != 0x93 ||
      memcmp(magic + 1, "NUMPY", 5) != 0) {
    fclose(f);
    return -1;
  }
  // v1.x only: v2+/v3+ use a 4-byte header length this parser does not
  // speak — reject instead of misreading the data offset
  if (magic[6] != 1) {
    fclose(f);
    return -2;
  }
  unsigned short hlen;
  if (fread(&hlen, 2, 1, f) != 1) {
    fclose(f);
    return -1;
  }
  std::string header(hlen, '\0');
  if (fread(&header[0], 1, hlen, f) != hlen) {
    fclose(f);
    return -1;
  }
  fclose(f);
  auto dpos = header.find("'descr':");
  auto spos = header.find("'shape':");
  if (dpos == std::string::npos || spos == std::string::npos) return -1;
  auto q1 = header.find('\'', dpos + 8);
  auto q2 = header.find('\'', q1 + 1);
  std::string descr = header.substr(q1 + 1, q2 - q1 - 1);
  if (descr == "<f4") strcpy(dtype_out, "f4");
  else if (descr == "|u1") strcpy(dtype_out, "u1");
  else if (descr == "|i1") strcpy(dtype_out, "i1");
  else if (descr == "<i4") strcpy(dtype_out, "i4");
  else return -2;
  // C-order only (this loader hands the raw buffer to row-major numpy)
  if (header.find("'fortran_order': True") != std::string::npos) return -2;
  long long nn = 0, dd = 1;
  auto p1 = header.find('(', spos);
  if (p1 == std::string::npos) return -1;
  auto p2 = header.find(')', p1);
  if (p2 == std::string::npos) return -1;
  // reject >2-D shapes: "(n,)" and "(n, d)" have <= 1 comma before a digit
  int dims = 0;
  for (auto i = p1 + 1; i < p2; i++) {
    if (isdigit((unsigned char)header[i])) {
      dims++;
      while (i < p2 && isdigit((unsigned char)header[i])) i++;
    }
  }
  if (dims > 2) return -2;
  if (sscanf(header.c_str() + p1, "(%lld, %lld", &nn, &dd) < 1) return -1;
  *n_out = nn;
  *d_out = dd;
  return 0;
}

int fn_npy_read(const char* path, void* dst, int64_t nbytes) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  unsigned char pre[10];
  if (fread(pre, 1, 10, f) != 10 || pre[6] != 1) {  // v1.x only, see header
    fclose(f);
    return -1;
  }
  unsigned short hlen = (unsigned short)(pre[8] | (pre[9] << 8));
  fseek(f, 10 + hlen, SEEK_SET);
  size_t got = fread(dst, 1, (size_t)nbytes, f);
  fclose(f);
  return got == (size_t)nbytes ? 0 : -1;
}

int fn_npy_write(const char* path, const void* src, int64_t n, int64_t d,
                 const char* descr /* "<f4" etc */, int64_t elem_size) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  char dict[256];
  snprintf(dict, sizeof dict,
           "{'descr': '%s', 'fortran_order': False, 'shape': (%lld, %lld), }",
           descr, (long long)n, (long long)d);
  size_t dlen = strlen(dict);
  size_t total = 10 + dlen + 1;
  size_t pad = (64 - total % 64) % 64;
  unsigned short hlen = (unsigned short)(dlen + pad + 1);
  fwrite("\x93NUMPY\x01\x00", 1, 8, f);
  fwrite(&hlen, 2, 1, f);
  fwrite(dict, 1, dlen, f);
  for (size_t i = 0; i < pad; i++) fputc(' ', f);
  fputc('\n', f);
  fwrite(src, (size_t)elem_size, (size_t)(n * d), f);
  fclose(f);
  return 0;
}

}  // extern "C"
