// Host-side Hungarian solver: minimum weighted bipartite vertex cover /
// maximum weight bipartite matching.
//
// The PyTorch port's own copy of native/hungarian.cc (the JAX package's
// host solver, which its matcher='native' path calls), kept byte for byte
// below this comment so both packages choose the same matching, ties
// included: initialise cover c_x = row max, c_y = 0; repeat { build the
// equality graph (|c_x + c_y - w| <= 1e-6 and (c_x > 0 or c_y > 0)); find a
// maximum bipartite matching on it via BFS max-flow; if saturating, stop;
// otherwise grow Hungarian trees (S, T) and lower the cover by the minimum
// slack }.
//
// Built with the C++ compiler by rec_attend_tpu_torch/ops/cuda/build.py and
// called through ctypes by rec_attend_tpu_torch/ops/hungarian.py; no
// Python or PyTorch dependencies.
//
// Iteration caps: the outer cover loop stops after 1000 rounds and returns
// the partial matching; inner loops report an error code.

#include <cmath>
#include <cstring>
#include <deque>
#include <set>
#include <vector>

namespace {

constexpr float kEpsilon = 1e-6f;
constexpr int kMaxIter = 1000;

using Mat = std::vector<float>;  // row-major

inline float &at(Mat &m, int cols, int r, int c) { return m[r * cols + c]; }
inline float at(const Mat &m, int cols, int r, int c) {
  return m[r * cols + c];
}

// One BFS augmentation on the flow network. Returns true if an augmenting
// s->t path was found. FIFO queue, neighbours visited in index order.
bool Augment(const Mat &capacity, Mat &flow, Mat &residual, int n, int *err) {
  int s = 0, t = n - 1;
  std::deque<int> q;
  q.push_back(s);
  std::vector<char> mark(n, 0);
  std::vector<int> parent(n, -1);
  bool found = false;

  for (int i = 0; !q.empty(); ++i) {
    if (i >= kMaxIter * n) {
      *err = 1;
      return false;
    }
    int v = q.front();
    q.pop_front();
    mark[v] = 1;
    if (v == t) {
      found = true;
      break;
    }
    for (int u = 0; u < n; ++u) {
      if (!mark[u] && at(residual, n, v, u) > 0) {
        q.push_back(u);
        parent[u] = v;
      }
    }
  }
  if (!found) return false;

  float b = 0.0f;
  for (int i = 0; i < n * n; ++i) b = std::max(b, capacity[i]);
  for (int v = t; parent[v] != -1; v = parent[v]) {
    b = std::min(b, at(residual, n, parent[v], v));
  }
  for (int v = t; parent[v] != -1; v = parent[v]) {
    int pv = parent[v];
    if (at(capacity, n, pv, v) > 0) {
      at(flow, n, pv, v) += b;
    } else {
      at(flow, n, v, pv) -= b;
    }
    at(residual, n, pv, v) -= b;
    at(residual, n, v, pv) += b;
  }
  return true;
}

// Maximum-cardinality bipartite matching on a 0/1 graph via max-flow.
void MaxBipartiteMatching(const Mat &graph, int n_x, int n_y, Mat *matching,
                          int *err) {
  int n = n_x + n_y + 2;
  int s = 0, t = n - 1, x0 = 1, y0 = n_x + 1;
  Mat capacity(n * n, 0.0f);
  for (int x = 0; x < n_x; ++x)
    for (int y = 0; y < n_y; ++y)
      at(capacity, n, x0 + x, y0 + y) = at(graph, n_y, x, y);
  for (int x = 0; x < n_x; ++x) at(capacity, n, s, x0 + x) = 1.0f;
  for (int y = 0; y < n_y; ++y) at(capacity, n, y0 + y, t) = 1.0f;

  Mat flow(n * n, 0.0f);
  Mat residual(capacity);
  for (int i = 0; Augment(capacity, flow, residual, n, err); ++i) {
    if (*err || i >= kMaxIter) {
      if (i >= kMaxIter) *err = 1;
      break;
    }
  }
  for (int x = 0; x < n_x; ++x)
    for (int y = 0; y < n_y; ++y)
      at(*matching, n_y, x, y) = at(flow, n, x0 + x, y0 + y);
}

bool IsSaturated(const Mat &m, int n_x, int n_y) {
  if (n_x >= n_y) {
    for (int y = 0; y < n_y; ++y) {
      float sum = 0;
      for (int x = 0; x < n_x; ++x) sum += at(m, n_y, x, y);
      if (sum == 0) return false;
    }
  } else {
    for (int x = 0; x < n_x; ++x) {
      float sum = 0;
      for (int y = 0; y < n_y; ++y) sum += at(m, n_y, x, y);
      if (sum == 0) return false;
    }
  }
  return true;
}

int MatchedX(const Mat &m, int n_x, int n_y, int y) {
  for (int x = 0; x < n_x; ++x)
    if (at(m, n_y, x, y) == 1.0f) return x;
  return -1;
}

int MatchedY(const Mat &m, int n_x, int n_y, int x) {
  for (int y = 0; y < n_y; ++y)
    if (at(m, n_y, x, y) == 1.0f) return y;
  return -1;
}

// Solve one instance. Returns 0 on success, 1 if an iteration cap was hit
// (partial matching is still written).
int SolveOne(const float *w, int n_x, int n_y, float *m_out, float *cx_out,
             float *cy_out) {
  Mat weights(w, w + n_x * n_y);
  std::vector<float> c_x(n_x), c_y(n_y, 0.0f);
  Mat matching(n_x * n_y, 0.0f);
  for (int x = 0; x < n_x; ++x) {
    float mx = weights[x * n_y];
    for (int y = 1; y < n_y; ++y) mx = std::max(mx, at(weights, n_y, x, y));
    c_x[x] = mx;
  }

  Mat equality(n_x * n_y, 0.0f);
  std::set<int> S, T;
  bool next_match = true;
  int err = 0;
  int rc = 0;

  for (int iter = 0;; ++iter) {
    if (iter >= kMaxIter) {
      rc = 1;  // graceful degradation, return partial matching
      break;
    }
    // Equality graph: tight and covered edges.
    for (int x = 0; x < n_x; ++x) {
      for (int y = 0; y < n_y; ++y) {
        float slack = c_x[x] + c_y[y] - at(weights, n_y, x, y);
        at(equality, n_y, x, y) =
            (std::fabs(slack) <= kEpsilon && (c_x[x] > 0 || c_y[y] > 0))
                ? 1.0f
                : 0.0f;
      }
    }
    if (next_match) {
      MaxBipartiteMatching(equality, n_x, n_y, &matching, &err);
      if (err) {
        rc = 1;
        break;
      }
      if (IsSaturated(matching, n_x, n_y)) break;
      for (int u = 0; u < n_x; ++u) {
        if (MatchedY(matching, n_x, n_y, u) == -1) {
          S.clear();
          S.insert(u);
          T.clear();
          break;
        }
      }
    }

    std::set<int> N_S;
    for (int x : S)
      for (int y = 0; y < n_y; ++y)
        if (at(equality, n_y, x, y) > 0) N_S.insert(y);

    if (N_S == T) {
      // Lower the cover by the minimum slack outside T.
      float a = 3.4e38f;
      for (int x : S)
        for (int y = 0; y < n_y; ++y)
          if (!T.count(y))
            a = std::min(a, c_x[x] + c_y[y] - at(weights, n_y, x, y));
      if (a < kEpsilon) {
        next_match = true;
        continue;
      }
      for (int x : S) c_x[x] -= a;
      for (int y : T) c_y[y] += a;
    } else {
      for (int j = 0; (int)N_S.size() > (int)T.size(); ++j) {
        if (j >= kMaxIter) {
          rc = 1;
          break;
        }
        int y = -1;
        for (int cand : N_S) {
          if (!T.count(cand)) {
            y = cand;
            break;
          }
        }
        int z = MatchedX(matching, n_x, n_y, y);
        if (z == -1) {
          next_match = true;
          break;
        }
        next_match = false;
        S.insert(z);
        for (int v = 0; v < n_y; ++v)
          if (at(equality, n_y, z, v) > 0) N_S.insert(v);
        T.insert(y);
      }
      if (rc) break;
    }
  }

  std::memcpy(m_out, matching.data(), sizeof(float) * n_x * n_y);
  std::memcpy(cx_out, c_x.data(), sizeof(float) * n_x);
  std::memcpy(cy_out, c_y.data(), sizeof(float) * n_y);
  return rc;
}

}  // namespace

extern "C" {

// Batched entry point. w: [b, n_x, n_y]; m: [b, n_x, n_y];
// cx: [b, n_x]; cy: [b, n_y]. Returns number of instances that hit an
// iteration cap (0 == all exact).
int hungarian_solve(const float *w, int b, int n_x, int n_y, float *m,
                    float *cx, float *cy) {
  int bad = 0;
  for (int i = 0; i < b; ++i) {
    bad += SolveOne(w + (size_t)i * n_x * n_y, n_x, n_y,
                    m + (size_t)i * n_x * n_y, cx + (size_t)i * n_x,
                    cy + (size_t)i * n_y);
  }
  return bad;
}

}  // extern "C"
