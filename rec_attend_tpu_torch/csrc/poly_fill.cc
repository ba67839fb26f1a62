// Fill one polygon into an image as cv2.fillPoly (OpenCV 5.0) does with
// LINE_8 and shift 0, pixel for pixel:
//
//   - the outline: the 8-connected Bresenham line of every edge, left to
//     right, clipped to the image first (Cohen-Sutherland in integers);
//   - the even-odd scanline fill of the edges in 16-bit fixed point, a
//     half pixel added to every x: on each row the edges of rows
//     [y0, y1) sorted by x, and of each pair the pixels
//     [x1 >> 16, (x2 - 1) >> 16];
//   - an edge's x on a row is exact (rounded down) on the line through its
//     end points, or, for an edge that leaves the image, through its
//     clipped end points; beyond a clipped end it lies outside the image
//     on the side it left by (0 on the left, cols << 16 on the right); an
//     edge clipped to one point stands at that point's x.
//
//   fill_poly(img, rows, cols, pix_size, value, pts, n)
//
// img: rows x cols pixels of pix_size bytes each, contiguous; value: the
// pix_size bytes written into every pixel of the polygon; pts: n (x, y)
// integer vertices.  Returns 0.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kShift = 16;
constexpr int64_t kOne = int64_t(1) << kShift;

struct Pt {
  int64_t x, y;
};

constexpr int64_t kNoSide = INT64_MIN;

struct Edge {
  int y0, y1;
  // x on row y: bx + floor((y - by) * num / den), or bx where den is 0.
  int64_t bx, by, num, den;
  // Rows above lo_y and from hi_y on lie outside the image at lo_x and
  // hi_x, where they are not kNoSide.
  int lo_y, hi_y;
  int64_t lo_x, hi_x;
};

int64_t floor_div(int64_t a, int64_t b) {
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

struct Image {
  uint8_t* data;
  int rows, cols, pix;
  const uint8_t* value;

  void set(int64_t x, int64_t y) const {
    std::memcpy(data + (y * cols + x) * pix, value, pix);
  }
  void span(int y, int x1, int x2) const {
    uint8_t* row = data + int64_t(y) * cols * pix;
    for (int x = x1; x <= x2; ++x) {
      std::memcpy(row + int64_t(x) * pix, value, pix);
    }
  }
};

// Cohen-Sutherland clipping to [0, cols - 1] x [0, rows - 1] in integers:
// the second end point is moved along the line as the first has been.
bool clip_line(int64_t cols, int64_t rows, Pt& p1, Pt& p2) {
  const int64_t right = cols - 1, bottom = rows - 1;
  if (cols <= 0 || rows <= 0) return false;
  int64_t &x1 = p1.x, &y1 = p1.y, &x2 = p2.x, &y2 = p2.y;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += (int64_t)((double)(a - y1) * (x2 - x1) / (y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += (int64_t)((double)(a - y2) * (x2 - x1) / (y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += (int64_t)((double)(a - x1) * (y2 - y1) / (x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += (int64_t)((double)(a - x2) * (y2 - y1) / (x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

bool outside(const Image& img, const Pt& p) {
  return (uint64_t)p.x >= (uint64_t)img.cols ||
         (uint64_t)p.y >= (uint64_t)img.rows;
}

// The 8-connected line from p1 to p2, left to right, after clipping.
void line8(const Image& img, Pt p1, Pt p2) {
  if ((outside(img, p1) || outside(img, p2)) &&
      !clip_line(img.cols, img.rows, p1, p2))
    return;
  int64_t dx = p2.x - p1.x, dy = p2.y - p1.y;
  if (dx < 0) {
    dx = -dx;
    dy = -dy;
    std::swap(p1, p2);
  }
  int64_t sy = 1;
  if (dy < 0) {
    dy = -dy;
    sy = -1;
  }
  const bool vert = dy > dx;
  if (vert) std::swap(dx, dy);
  int64_t err = dx - (dy + dy);
  const int64_t plus = dx + dx, minus = -(dy + dy);
  int64_t x = p1.x, y = p1.y;
  for (int64_t i = 0; i <= dx; ++i) {
    img.set(x, y);
    const bool step = err < 0;
    err += minus + (step ? plus : 0);
    if (vert) {
      y += sy;
      if (step) x += 1;
    } else {
      x += 1;
      if (step) y += sy;
    }
  }
}

void collect_edges(const Image& img, const std::vector<Pt>& v,
                   std::vector<Edge>& edges) {
  const int count = (int)v.size();
  const int64_t left = 0, right = (int64_t)img.cols << kShift;
  Pt pt0 = v[count - 1];
  for (int i = 0; i < count; ++i) {
    const Pt pt1 = v[i];
    line8(img, pt0, pt1);
    // The edge's line: its end points, or where it leaves the image.
    Pt c0 = pt0, c1 = pt1;
    Edge e{};
    e.lo_x = e.hi_x = kNoSide;
    bool vertical = false;
    if (outside(img, pt0) || outside(img, pt1)) {
      const bool inside = clip_line(img.cols, img.rows, c0, c1);
      if (c0.y == c1.y) {
        vertical = true;
      } else if (inside) {
        // Beyond a clipped end the edge runs outside the image: at the
        // side it left by.
        const Pt& lo = c0.y < c1.y ? c0 : c1;
        const Pt& hi = c0.y < c1.y ? c1 : c0;
        e.lo_y = (int)lo.y;
        e.hi_y = (int)hi.y;
        e.lo_x = lo.x == 0 ? left : lo.x == img.cols - 1 ? right : kNoSide;
        e.hi_x = hi.x == 0 ? left : hi.x == img.cols - 1 ? right : kNoSide;
      }
    }
    if (pt0.y != pt1.y) {
      const int64_t x0 = (c0.x << kShift) + (kOne >> 1);
      const int64_t x1 = (c1.x << kShift) + (kOne >> 1);
      e.y0 = (int)std::min(pt0.y, pt1.y);
      e.y1 = (int)std::max(pt0.y, pt1.y);
      e.num = x1 - x0;
      e.den = vertical ? 0 : c1.y - c0.y;
      e.bx = pt0.y < pt1.y ? x0 : x1;
      e.by = pt0.y < pt1.y ? c0.y : c1.y;
      edges.push_back(e);
    }
    pt0 = pt1;
  }
}

// The x of an edge on row y.
int64_t edge_x(const Edge& e, int y) {
  if (e.lo_x != kNoSide && y < e.lo_y) return e.lo_x;
  if (e.hi_x != kNoSide && y >= e.hi_y) return e.hi_x;
  return e.den ? e.bx + floor_div((y - e.by) * e.num, e.den) : e.bx;
}

// Even-odd fill: on each row the active edges (y0 <= y < y1) sorted by x,
// the pixels from the first of each pair to the second, the second
// exclusive: [x1 >> 16, (x2 - 1) >> 16].
void fill_edges(const Image& img, const std::vector<Edge>& edges) {
  if (edges.size() < 2) return;
  int y_min = INT_MAX, y_max = INT_MIN;
  for (const Edge& e : edges) {
    y_min = std::min(y_min, e.y0);
    y_max = std::max(y_max, e.y1);
  }
  std::vector<int64_t> xs;
  xs.reserve(edges.size());
  for (int y = std::max(y_min, 0); y < std::min(y_max, img.rows); ++y) {
    xs.clear();
    for (const Edge& e : edges) {
      if (e.y0 <= y && y < e.y1) xs.push_back(edge_x(e, y));
    }
    std::sort(xs.begin(), xs.end());
    for (size_t k = 0; k + 1 < xs.size(); k += 2) {
      const int64_t x1 = std::max<int64_t>(xs[k] >> kShift, 0);
      const int64_t x2 =
          std::min<int64_t>((xs[k + 1] - 1) >> kShift, img.cols - 1);
      if (x1 <= x2) img.span(y, (int)x1, (int)x2);
    }
  }
}

}  // namespace

extern "C" int fill_poly(uint8_t* data, int rows, int cols, int pix_size,
                         const uint8_t* value, const int64_t* pts, int n) {
  if (n <= 0) return 0;
  Image img{data, rows, cols, pix_size, value};
  std::vector<Pt> v(n);
  for (int i = 0; i < n; ++i) v[i] = {pts[2 * i], pts[2 * i + 1]};
  std::vector<Edge> edges;
  edges.reserve(n + 1);
  collect_edges(img, v, edges);
  fill_edges(img, edges);
  return 0;
}
