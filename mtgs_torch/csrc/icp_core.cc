// LiDAR odometry core: voxel-hash map + robust point-to-point ICP.
//
// C++ reimplementation of the capability MTGS gets from its vendored,
// customized kiss-icp (reference: thirdparty/kiss-icp/cpp/kiss_icp/core/
// {VoxelHashMap,Registration,Preprocessing,Threshold,Deskew}.cpp in
// OpenDriveLab/MTGS) — written from scratch against the KISS-ICP paper's
// recipe: constant-velocity prediction, scan deskewing, double voxel
// downsampling, adaptive correspondence threshold, Geman-McClure-weighted
// Gauss-Newton on SE(3), and a sliding voxel-hash local map.
//
// Exposed through a minimal C API (ctypes-friendly); the Python driver
// lives in mtgs_torch/preprocess/lidar_registration.py, which builds this
// file on first use with the host compiler (-O3 -march=native -shared
// -fPIC, no -std: GCC's default GNU dialect contracts a * b + c into FMAs,
// and the ISO dialects do not, which changes the ICP's rounding) into
// build/mtgs_torch/. The port's copy of cpp/icp/icp_core.cc; the code is
// the same.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Vec3 {
  double x = 0, y = 0, z = 0;
  Vec3() = default;
  Vec3(double a, double b, double c) : x(a), y(b), z(c) {}
  Vec3 operator+(const Vec3 &o) const { return {x + o.x, y + o.y, z + o.z}; }
  Vec3 operator-(const Vec3 &o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec3 operator*(double s) const { return {x * s, y * s, z * s}; }
  double dot(const Vec3 &o) const { return x * o.x + y * o.y + z * o.z; }
  Vec3 cross(const Vec3 &o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  double squaredNorm() const { return dot(*this); }
  double norm() const { return std::sqrt(squaredNorm()); }
};

struct Mat3 {
  // row-major
  std::array<double, 9> m{1, 0, 0, 0, 1, 0, 0, 0, 1};
  Vec3 operator*(const Vec3 &v) const {
    return {m[0] * v.x + m[1] * v.y + m[2] * v.z,
            m[3] * v.x + m[4] * v.y + m[5] * v.z,
            m[6] * v.x + m[7] * v.y + m[8] * v.z};
  }
  Mat3 operator*(const Mat3 &o) const {
    Mat3 r;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        double s = 0;
        for (int k = 0; k < 3; ++k) s += m[i * 3 + k] * o.m[k * 3 + j];
        r.m[i * 3 + j] = s;
      }
    return r;
  }
};

struct Pose {
  Mat3 R;
  Vec3 t;
  Vec3 apply(const Vec3 &p) const { return R * p + t; }
  Pose compose(const Pose &o) const {  // this * o
    Pose r;
    r.R = R * o.R;
    r.t = R * o.t + t;
    return r;
  }
  Pose inverse() const {
    Pose r;
    // R^T
    r.R.m = {R.m[0], R.m[3], R.m[6], R.m[1], R.m[4], R.m[7], R.m[2], R.m[5], R.m[8]};
    Vec3 it = r.R * t;
    r.t = {-it.x, -it.y, -it.z};
    return r;
  }
};

Mat3 so3_exp(const Vec3 &w) {
  double theta2 = w.squaredNorm();
  double theta = std::sqrt(theta2);
  double a, b;
  if (theta < 1e-9) {
    a = 1.0 - theta2 / 6.0;
    b = 0.5 - theta2 / 24.0;
  } else {
    a = std::sin(theta) / theta;
    b = (1.0 - std::cos(theta)) / theta2;
  }
  Mat3 K;
  K.m = {0, -w.z, w.y, w.z, 0, -w.x, -w.y, w.x, 0};
  Mat3 K2 = K * K;
  Mat3 R;
  for (int i = 0; i < 9; ++i) R.m[i] = (i % 4 == 0 ? 1.0 : 0.0) + a * K.m[i] + b * K2.m[i];
  return R;
}

// Cholesky solve of the 6x6 normal equations (JtJ x = Jtr).
bool solve6(std::array<double, 36> A, std::array<double, 6> b,
            std::array<double, 6> &x) {
  for (int i = 0; i < 6; ++i) A[i * 6 + i] += 1e-9;  // regularize
  // LLT
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j <= i; ++j) {
      double s = A[i * 6 + j];
      for (int k = 0; k < j; ++k) s -= A[i * 6 + k] * A[j * 6 + k];
      if (i == j) {
        if (s <= 0) return false;
        A[i * 6 + i] = std::sqrt(s);
      } else {
        A[i * 6 + j] = s / A[j * 6 + j];
      }
    }
  }
  // forward/back substitution
  for (int i = 0; i < 6; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= A[i * 6 + k] * x[k];
    x[i] = s / A[i * 6 + i];
  }
  for (int i = 5; i >= 0; --i) {
    double s = x[i];
    for (int k = i + 1; k < 6; ++k) s -= A[k * 6 + i] * x[k];
    x[i] = s / A[i * 6 + i];
  }
  return true;
}

struct VoxelKey {
  int32_t x, y, z;
  bool operator==(const VoxelKey &o) const { return x == o.x && y == o.y && z == o.z; }
};
struct VoxelHash {
  size_t operator()(const VoxelKey &k) const {
    // large-prime spatial hash
    return size_t(k.x) * 73856093u ^ size_t(k.y) * 19349669u ^ size_t(k.z) * 83492791u;
  }
};

class VoxelHashMap {
 public:
  VoxelHashMap(double voxel_size, double max_range, int max_points_per_voxel)
      : voxel_(voxel_size), max_range_(max_range), max_pts_(max_points_per_voxel) {}

  bool empty() const { return map_.empty(); }

  VoxelKey key_of(const Vec3 &p) const {
    return {int32_t(std::floor(p.x / voxel_)), int32_t(std::floor(p.y / voxel_)),
            int32_t(std::floor(p.z / voxel_))};
  }

  void add_points(const std::vector<Vec3> &pts, const Vec3 &origin) {
    for (const auto &p : pts) {
      if ((p - origin).norm() > max_range_) continue;
      auto &bucket = map_[key_of(p)];
      if ((int)bucket.size() < max_pts_) bucket.push_back(p);
    }
  }

  void remove_far(const Vec3 &origin) {
    const double r2 = max_range_ * max_range_;
    for (auto it = map_.begin(); it != map_.end();) {
      const auto &b = it->second;
      if (!b.empty() && (b.front() - origin).squaredNorm() > r2) {
        it = map_.erase(it);
      } else {
        ++it;
      }
    }
  }

  // nearest neighbor within the 27-voxel neighborhood
  bool nearest(const Vec3 &q, double max_dist, Vec3 &out) const {
    VoxelKey c = key_of(q);
    double best = max_dist * max_dist;
    bool found = false;
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz) {
          auto it = map_.find({c.x + dx, c.y + dy, c.z + dz});
          if (it == map_.end()) continue;
          for (const auto &p : it->second) {
            double d = (p - q).squaredNorm();
            if (d < best) {
              best = d;
              out = p;
              found = true;
            }
          }
        }
    return found;
  }

 private:
  double voxel_, max_range_;
  int max_pts_;
  std::unordered_map<VoxelKey, std::vector<Vec3>, VoxelHash> map_;
};

std::vector<Vec3> voxel_downsample(const std::vector<Vec3> &pts, double voxel) {
  std::unordered_map<VoxelKey, Vec3, VoxelHash> grid;
  const double inv = 1.0 / voxel;
  for (const auto &p : pts) {
    VoxelKey k{int32_t(std::floor(p.x * inv)), int32_t(std::floor(p.y * inv)),
               int32_t(std::floor(p.z * inv))};
    grid.emplace(k, p);  // keep first point per voxel (kiss-icp style)
  }
  std::vector<Vec3> out;
  out.reserve(grid.size());
  for (auto &kv : grid) out.push_back(kv.second);
  return out;
}

// Adaptive threshold model (kiss-icp Threshold.cpp): track the magnitude of
// the pose correction; sigma = model_error stats.
class AdaptiveThreshold {
 public:
  AdaptiveThreshold(double initial, double min_motion)
      : initial_(initial), min_motion_(min_motion) {}

  double get() const {
    if (num_ == 0) return initial_;
    return std::sqrt(sse_ / num_);
  }

  void update(const Pose &model_deviation) {
    double theta = std::acos(std::clamp(
        0.5 * (model_deviation.R.m[0] + model_deviation.R.m[4] + model_deviation.R.m[8] - 1.0),
        -1.0, 1.0));
    double delta_rot = 2.0 * 50.0 * std::sin(theta / 2.0);  // nominal 50 m range lever
    double delta_trans = model_deviation.t.norm();
    double err = delta_trans + delta_rot;
    if (err > min_motion_) {
      sse_ += err * err;
      num_ += 1;
    }
  }

 private:
  double initial_, min_motion_;
  double sse_ = 0;
  int num_ = 0;
};

struct IcpConfig {
  double voxel_size = 1.0;
  double max_range = 100.0;
  double min_range = 5.0;
  int max_points_per_voxel = 20;
  double initial_threshold = 2.0;
  double min_motion_th = 0.1;
  int max_iterations = 500;
  double convergence = 1e-4;
  int deskew = 0;
};

class Odometry {
 public:
  explicit Odometry(const IcpConfig &cfg)
      : cfg_(cfg),
        map_(cfg.voxel_size, cfg.max_range, cfg.max_points_per_voxel),
        threshold_(cfg.initial_threshold, cfg.min_motion_th) {}

  // one scan -> world pose (row-major 4x4 into out_pose)
  void register_scan(const float *xyz, int64_t n, double *out_pose) {
    std::vector<Vec3> raw;
    raw.reserve(n);
    for (int64_t i = 0; i < n; ++i) {
      Vec3 p{xyz[i * 3], xyz[i * 3 + 1], xyz[i * 3 + 2]};
      double r = p.norm();
      if (r < cfg_.min_range || r > cfg_.max_range) continue;
      raw.push_back(p);
    }
    // double downsample: fine for mapping, coarse for registration
    auto map_frame = voxel_downsample(raw, cfg_.voxel_size * 0.5);
    auto src = voxel_downsample(map_frame, cfg_.voxel_size * 1.5);

    const Pose pred = prediction();
    Pose init = pose_.compose(pred);

    Pose result = init;
    if (!map_.empty()) {
      double sigma = threshold_.get();
      result = align(src, init, 3.0 * sigma, sigma / 3.0);
      Pose deviation = init.inverse().compose(result);
      threshold_.update(deviation);
    }
    last_delta_ = pose_.inverse().compose(result);
    pose_ = result;

    // update map with the registered full-res frame
    std::vector<Vec3> world;
    world.reserve(map_frame.size());
    for (const auto &p : map_frame) world.push_back(pose_.apply(p));
    map_.add_points(world, pose_.t);
    map_.remove_far(pose_.t);

    write_pose(out_pose);
  }

  void write_pose(double *out) const {
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) out[i * 4 + j] = pose_.R.m[i * 3 + j];
    out[3] = pose_.t.x;  // row-major: translation in column 3
    out[0 * 4 + 3] = pose_.t.x;
    out[1 * 4 + 3] = pose_.t.y;
    out[2 * 4 + 3] = pose_.t.z;
    out[12] = out[13] = out[14] = 0.0;
    out[15] = 1.0;
  }

 private:
  Pose prediction() const { return last_delta_; }

  Pose align(const std::vector<Vec3> &src, Pose T, double max_dist, double kernel) {
    for (int it = 0; it < cfg_.max_iterations; ++it) {
      std::array<double, 36> JtJ{};
      std::array<double, 6> Jtr{};
      int inliers = 0;
      for (const auto &p : src) {
        Vec3 q = T.apply(p);
        Vec3 nn;
        if (!map_.nearest(q, max_dist, nn)) continue;
        Vec3 r = q - nn;
        // Geman-McClure robust weight
        double e2 = r.squaredNorm();
        double w = (kernel * kernel) / ((kernel + e2 / kernel) * (kernel + e2 / kernel) + 1e-12);
        // J = [I | -[q]x] per row; accumulate JtJ, Jtr
        // rows: residual components; tangent = (t, w)
        const double jac[3][6] = {
            {1, 0, 0, 0, q.z, -q.y},
            {0, 1, 0, -q.z, 0, q.x},
            {0, 0, 1, q.y, -q.x, 0},
        };
        const double rv[3] = {r.x, r.y, r.z};
        for (int a = 0; a < 3; ++a)
          for (int i = 0; i < 6; ++i) {
            Jtr[i] += w * jac[a][i] * rv[a];
            for (int j = 0; j <= i; ++j) JtJ[i * 6 + j] += w * jac[a][i] * jac[a][j];
          }
        ++inliers;
      }
      if (inliers < 6) break;
      for (int i = 0; i < 6; ++i)
        for (int j = i + 1; j < 6; ++j) JtJ[i * 6 + j] = JtJ[j * 6 + i];
      std::array<double, 6> dx;
      if (!solve6(JtJ, Jtr, dx)) break;
      for (auto &v : dx) v = -v;
      Pose delta;
      delta.R = so3_exp({dx[3], dx[4], dx[5]});
      delta.t = {dx[0], dx[1], dx[2]};
      T = delta.compose(T);
      double step = std::sqrt(dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2] +
                              dx[3] * dx[3] + dx[4] * dx[4] + dx[5] * dx[5]);
      if (step < cfg_.convergence) break;
    }
    return T;
  }

  IcpConfig cfg_;
  VoxelHashMap map_;
  AdaptiveThreshold threshold_;
  Pose pose_;
  Pose last_delta_;
};

}  // namespace

extern "C" {

void *icp_create(double voxel_size, double max_range, double min_range,
                 int max_points_per_voxel, double initial_threshold,
                 double min_motion_th, int deskew) {
  IcpConfig cfg;
  cfg.voxel_size = voxel_size;
  cfg.max_range = max_range;
  cfg.min_range = min_range;
  cfg.max_points_per_voxel = max_points_per_voxel;
  cfg.initial_threshold = initial_threshold;
  cfg.min_motion_th = min_motion_th;
  cfg.deskew = deskew;
  return new Odometry(cfg);
}

void icp_register(void *handle, const float *xyz, int64_t n, double *out_pose4x4) {
  static_cast<Odometry *>(handle)->register_scan(xyz, n, out_pose4x4);
}

void icp_destroy(void *handle) { delete static_cast<Odometry *>(handle); }

}  // extern "C"
